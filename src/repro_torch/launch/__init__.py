"""Launch drivers of the port: ``serve`` (batched greedy decode).  The
reference's train, dry-run, mesh and service drivers are not ported yet
(ROADMAP M9, M10)."""
