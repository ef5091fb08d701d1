import os
import sys

# smoke tests and benches must see the single real CPU device — the 512-way
# host-device override belongs ONLY to repro.launch.dryrun (its own process).
assert "xla_force_host_platform_device_count" not in \
    os.environ.get("XLA_FLAGS", ""), \
    "do not set the dry-run XLA_FLAGS globally (see system design notes)"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest

# Property-test modules need hypothesis; in containers without it, skip
# their collection instead of erroring the whole run.
try:
    import hypothesis  # noqa: F401
except ImportError:
    collect_ignore = ["test_greedyada.py", "test_kernels.py",
                      "test_partition.py", "test_serialize.py"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess-heavy tests (compile or multi-device)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run on the "
        "card with `pytest -m cuda tests/test_torch_cuda.py`")


@pytest.fixture()
def rng():
    return np.random.RandomState(0)
