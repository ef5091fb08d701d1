from repro_torch.tracking.store import (  # noqa: F401
    ClientMetrics, RoundMetrics, TaskMetrics, Tracker,
)
