"""The port's numpy data layer, selection RNG and batch schedule are bit
for bit the reference's."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import client as ref_client  # noqa: E402
from repro.core.batched import BatchedExecutor as RefExecutor  # noqa: E402
from repro.core.config import Config as RefConfig  # noqa: E402
from repro.core.config import DataConfig as RefDataConfig  # noqa: E402
from repro.core.local_train import cyclic_batches as ref_cyclic  # noqa: E402
from repro.core.server import Server as RefServer  # noqa: E402
from repro.data import fed_data as ref_fed  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro.simulation import heterogeneity as ref_het  # noqa: E402
from repro_torch.core import client as port_client  # noqa: E402
from repro_torch.core.batched import BatchedExecutor as PortExecutor  # noqa: E402
from repro_torch.core.config import Config as PortConfig  # noqa: E402
from repro_torch.core.config import DataConfig as PortDataConfig  # noqa: E402
from repro_torch.core.local_train import cyclic_batches as port_cyclic  # noqa: E402
from repro_torch.core.server import Server as PortServer  # noqa: E402
from repro_torch.data import fed_data as port_fed  # noqa: E402
from repro_torch.data import synthetic as port_syn  # noqa: E402
from repro_torch.simulation import heterogeneity as port_het  # noqa: E402

repro_torch.set_device("cpu")


def _same_fed(a, b):
    assert list(a.client_ids) == list(b.client_ids)
    for cid in a.client_ids:
        np.testing.assert_array_equal(a.clients[cid].x, b.clients[cid].x)
        np.testing.assert_array_equal(a.clients[cid].y, b.clients[cid].y)
        assert a.clients[cid].x.dtype == b.clients[cid].x.dtype
    np.testing.assert_array_equal(a.test.x, b.test.x)
    np.testing.assert_array_equal(a.test.y, b.test.y)
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("kw", [
    dict(dataset="synthetic", num_clients=12, partition="iid"),
    dict(dataset="synthetic", num_clients=12, partition="dir", dir_alpha=0.3),
    dict(dataset="synthetic", num_clients=12, partition="class",
         classes_per_client=3),
    dict(dataset="synthetic", num_clients=12, partition="iid",
         unbalanced=True, data_amount=0.5, seed=3),
    dict(dataset="femnist", num_clients=30, partition="realistic",
         unbalanced=True),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_federated_datasets_bit_equal(kw):
    _same_fed(ref_fed.build_federated_data(RefDataConfig(**kw)),
              port_fed.build_federated_data(PortDataConfig(**kw)))


@pytest.mark.parametrize("name", ["synthetic", "femnist"])
def test_virtual_shards_and_id_space_bit_equal(name):
    for i in (0, 5, 999_999):
        for ra, pa in zip(ref_syn.make_client_shard(name, i, 16, seed=2),
                          port_syn.make_client_shard(name, i, 16, seed=2)):
            np.testing.assert_array_equal(ra, pa)
    ref_ids = ref_fed.ClientIdSpace(1_000_000)
    port_ids = port_fed.ClientIdSpace(1_000_000)
    assert ref_ids.sample(np.random.RandomState(4), 50) == \
        port_ids.sample(np.random.RandomState(4), 50)


def test_selection_rng_bit_equal():
    rcfg = RefConfig.make({"server": {"clients_per_round": 7}, "seed": 11})
    pcfg = PortConfig.make({"server": {"clients_per_round": 7}, "seed": 11})
    ids = [f"client_{i:04d}" for i in range(40)]
    rs, ps = RefServer(None, rcfg), PortServer(None, pcfg)
    for r in range(5):
        assert rs.selection(ids, r) == ps.selection(ids, r)


def test_batch_schedule_and_hashes_bit_equal():
    for n, b, seed in [(100, 32, 0), (7, 32, 5), (64, 64, 123)]:
        np.testing.assert_array_equal(ref_cyclic(n, b, seed),
                                      port_cyclic(n, b, seed))
    for cid in ["client_0000", "client_0042", "x"]:
        assert ref_client._stable_hash(cid) == port_client._stable_hash(cid)
        assert ref_het._stable_hash(cid) == port_het._stable_hash(cid)

    class _C:     # the attributes the executors' schedule reads
        def __init__(self, cid, n):
            self.client_id, self.data = cid, np.zeros((n, 1))
            self.cfg = type("cfg", (), {"local_epochs": 3})()

        def _batch_size(self):
            return 16

    for cid, n in [("client_0003", 50), ("client_0100", 9)]:
        np.testing.assert_array_equal(
            RefExecutor._batch_indices(None, _C(cid, n), 4),
            PortExecutor._batch_indices(None, _C(cid, n), 4))


def test_heterogeneity_sampling_bit_equal():
    from repro.core.config import SystemHeterogeneityConfig as RefH
    from repro_torch.core.config import SystemHeterogeneityConfig as PortH
    kw = dict(enabled=True, seed=3,
              hyperparam_choices={"lr": (0.05, 0.1), "momentum": (0.0, 0.9)})
    rh, ph = ref_het.SystemHeterogeneity(RefH(**kw)), \
        port_het.SystemHeterogeneity(PortH(**kw))
    for i in range(20):
        cid = f"client_{i:04d}"
        assert rh.speed_ratio(cid) == ph.speed_ratio(cid)
        assert rh.hyperparam_overrides(cid) == ph.hyperparam_overrides(cid)
