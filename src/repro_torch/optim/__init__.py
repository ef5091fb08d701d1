from repro_torch.optim.optimizers import (  # noqa: F401
    AdamWHParams, Optimizer, SGDHParams, TracedOptimizer, adamw,
    adamw_traced, apply_updates, get_optimizer,
    global_norm, hparams_from_config, normalize_family, sgd, sgd_traced,
)
