"""Launch drivers of the port: ``train`` (the LLM train driver on
``models.model.make_train_step``), ``serve`` (batched greedy decode) and
``service`` (the deployment's registry, tracker, client and server roles).
The reference's dry-run and mesh drivers are not ported yet (ROADMAP
M9)."""
