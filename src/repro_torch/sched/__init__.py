from repro_torch.sched.greedyada import (  # noqa: F401
    ClientProfile, GreedyAda, one_per_device, random_allocation,
    slowest_allocation,
)
