from repro_torch.checkpoint.store import (  # noqa: F401
    available_steps, latest_step, load_checkpoint, save_checkpoint,
)
