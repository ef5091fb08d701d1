"""Launch drivers of the port: ``serve`` (batched greedy decode) and
``service`` (the deployment's registry, tracker, client and server roles).
The reference's train, dry-run and mesh drivers are not ported yet
(ROADMAP M9)."""
