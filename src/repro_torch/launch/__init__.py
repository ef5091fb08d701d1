"""Launch drivers of the port: ``train`` (the LLM train driver on
``models.model.TrainStep``), ``serve`` (batched greedy decode),
``service`` (the deployment's registry, tracker, client and server roles)
and ``dryrun`` (a step's roofline over the reference's production meshes,
``mesh`` / ``shardings`` / ``roofline``, on fake tensors)."""
