from repro_torch.simulation.heterogeneity import (  # noqa: F401
    SystemHeterogeneity, straggler_stats,
)
