"""The port's config tree, validation and flat-key folding against the
reference (``repro.core.config`` / ``repro.core.api``)."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import config as ref_config  # noqa: E402
from repro_torch.core import api as port_api  # noqa: E402
from repro_torch.core import config as port_config  # noqa: E402

repro_torch.set_device("cpu")

SECTIONS = ["DataConfig", "ServerConfig", "ClientConfig", "FaultConfig",
            "CheckpointConfig", "SystemHeterogeneityConfig", "ResourceConfig",
            "TrackingConfig", "Config", "MoEConfig", "MLAConfig", "ArchConfig"]


@pytest.mark.parametrize("name", SECTIONS)
def test_dataclass_fields_and_defaults_match(name):
    ref_cls = getattr(ref_config, name)
    port_cls = getattr(port_config, name)
    ref_f = [(f.name, str(f.type)) for f in dataclasses.fields(ref_cls)]
    port_f = [(f.name, str(f.type)) for f in dataclasses.fields(port_cls)]
    assert ref_f == port_f
    ref_d = dataclasses.asdict(ref_cls())
    port_d = dataclasses.asdict(port_cls())
    assert ref_d == port_d


def test_default_config_trees_equal():
    assert port_config.to_dict(port_config.Config()) == \
        ref_config.to_dict(ref_config.Config())
    assert port_config.SAMPLEABLE_HPARAMS == ref_config.SAMPLEABLE_HPARAMS


BAD = [
    {"task_id": ""},
    {"seed": 1.5},
    {"data": {"num_clients": 0}},
    {"data": {"batch_size": 0}},
    {"data": {"virtual": "maybe"}},
    {"server": {"rounds": -1}},
    {"server": {"clients_per_round": 0}},
    {"server": {"server_lr": 0.0}},
    {"client": {"lr": -0.1}},
    {"client": {"momentum": 1.0}},
    {"client": {"adam_eps": 0.0}},
    {"client": {"finetune": "partial"}},
    {"client": {"finetune": "lora", "lora_rank": 0}},
    {"client": {"lora_targets": "wq"}},
    {"resources": {"execution": "turbo"}},
    {"resources": {"distributed": "model"}},
    {"resources": {"distributed": "data"}},
    {"resources": {"aggregation_topology": "ring"}},
    {"resources": {"aggregation_fanout": 1}},
    {"resources": {"round_fusion": "always"}},
    {"resources": {"round_deadline": -1.0}},
    {"resources": {"buffer_size": -1}},
    {"faults": {"dropout_prob": 1.5}},
    {"faults": {"straggler_slowdown": 0.5}},
    {"faults": {"seed": "x"}},
    {"checkpoint": {"every": -1}},
    {"tracking": {"round_sync": False}, "faults": {"dropout_prob": 0.1}},
    {"system_heterogeneity": {"hyperparam_choices": {"optimizer": ["sgd"]}}},
    {"system_heterogeneity": {"hyperparam_choices": {"lr": []}}},
]


def _error(mod, overrides):
    try:
        mod.validate_config(mod.Config.make(overrides))
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("overrides", BAD, ids=lambda o: str(o)[:60])
def test_bad_configs_raise_identical_errors(overrides):
    ref = _error(ref_config, overrides)
    assert ref is not None
    assert _error(port_config, overrides) == ref


@pytest.mark.parametrize("overrides", [
    {"unknown_key": 1},
    {"data": {"datasett": "femnist"}},
    {"resources": {"excution": "batched"}},
])
def test_unknown_keys_raise_identical_key_errors(overrides):
    with pytest.raises(KeyError) as ref:
        ref_config.Config.make(overrides)
    with pytest.raises(KeyError) as port:
        port_config.Config.make(overrides)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("flat", [
    {"dataset": "synthetic", "clients_per_round": 3, "lora_rank": 4},
    {"execution": "batched", "aggregation_kernel": True, "local_epochs": 2},
    {"compression": "stc"},                       # ambiguous: client/server
    {"seed": 3, "batch_size": 8, "data": {"batch_size": 16}},   # conflict
    {"stc_sparsity": 0.05, "client": {"stc_sparsity": 0.05}},
])
def test_flat_key_folding_matches_reference(flat):
    def fold(mod):
        try:
            return mod._fold_flat_keys(dict(flat))
        except KeyError as e:
            return ("KeyError", str(e))
    assert fold(port_api) == fold(ref_api)
