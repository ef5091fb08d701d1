"""Federated LoRA fine-tuning of ``tiny_lm``: the reference's two engines
against a hand-written oracle, and the port against the reference.

The oracle (one client's local SGD with momentum, written with ``jax.grad``
over the reference's ``lora_wrap`` and its ``cyclic_batches`` schedule)
settles the sequential-vs-batched disagreement of ``tests/test_lora.py``:

* with LoRA on the attention projections, the oracle, the sequential engine
  and the batched engine agree within 1e-5;
* with every eligible leaf adapted (the token embedding included, the
  reference test's setting), the local training is chaotic: starting the
  oracle from adapters perturbed by 1e-7 (relative) moves its result by
  more than 1e-2 after one epoch.  The two engines round differently in the
  merge (the batched one merges vmapped adapters into a shared base), so
  they cannot meet 1e-5 there — no engine computes a wrong thing.

The port's trajectory tests therefore run a well-conditioned setting —
rank 4, alpha 8 on the attention projections, where a 1e-7 perturbation of
the reference's start moves its 3-round result by less than 1e-6 (at
alpha 16 by more than 1e-5: ``test_slice_setting_is_well_conditioned``) —
and hold the port's batched engine to the reference's batched engine
(which equals the sequential one and the oracle there): params 1e-5,
train_loss 1e-4, ``comm_up_bytes`` exact.  Base and adapter
parameters are the reference's, injected.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro as ref_api  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.client import _stable_hash  # noqa: E402
from repro.core.local_train import cyclic_batches  # noqa: E402
from repro.models import lora as ref_lora  # noqa: E402
from repro.models.llm import tiny_lm as ref_tiny_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.rounds import Trainer  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import lora as port_lora  # noqa: E402
from repro_torch.models.llm import tiny_lm as port_tiny_lm  # noqa: E402
from repro_torch.models.small import FLModel  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and
    under a loaded parallel test run torch's thread pool made these runs
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATTN = ("attn",)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


# ---------------------------------------------------------------------------
# the oracle and the reference's two engines
# ---------------------------------------------------------------------------


def _ref_one_client(execution, targets):
    """One round, one client, rank 2 / alpha 8 (the reference's engines)."""
    ref_api.reset()
    ref_api.init({
        "model": "tiny_lm", "dataset": "tiny_lm",
        "data": {"num_clients": 8, "batch_size": 32},
        "server": {"rounds": 1, "clients_per_round": 1},
        "client": {"local_epochs": 1, "lr": 0.1, "finetune": "lora",
                   "lora_rank": 2, "lora_alpha": 8.0,
                   "lora_targets": targets},
        "resources": {"execution": execution}})
    res = ref_api.run()
    trainer = ref_api.core.api._ctx.trainer
    ref_api.reset()
    (cid,) = list(trainer.clients)
    return res, cid, trainer.fed_data.clients[cid]


def _oracle(targets, data, cid, perturb=0.0):
    """Local SGD (lr 0.1, momentum 0.9) by hand: ``jax.grad`` of the
    wrapped model's loss over the client's batch schedule."""
    model = ref_tiny_lm()
    wrapped = ref_lora.lora_wrap(model, model.init(jax.random.PRNGKey(0)),
                                 2, 8.0, targets)
    a = jax.tree_util.tree_map(lambda t: t * (1.0 + perturb),
                               wrapped.init(jax.random.PRNGKey(0)))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: wrapped.loss_and_metrics(p, b)[0]))
    mom = jax.tree_util.tree_map(jnp.zeros_like, a)
    losses = []
    for bidx in cyclic_batches(len(data.x), 32, _stable_hash(cid)):
        loss, g = grad(a, {"x": jnp.asarray(data.x[bidx]),
                           "y": jnp.asarray(data.y[bidx])})
        losses.append(float(loss))
        mom = jax.tree_util.tree_map(lambda m, q: 0.9 * m + q, mom, g)
        a = jax.tree_util.tree_map(lambda p, m: p - 0.1 * m, a, mom)
    return a, float(np.mean(losses))


def test_oracle_settles_the_reference_engines():
    oracle = None
    for execution in ("sequential", "batched"):
        res, cid, data = _ref_one_client(execution, ATTN)
        if oracle is None:
            oracle = _oracle(ATTN, data, cid)
        assert _max_diff(res["params"], oracle[0]) <= 1e-5, execution
        assert abs(res["history"][0]["train_loss"] - oracle[1]) <= 1e-4


def test_lora_with_every_leaf_adapted_is_chaotic():
    """The reference test's setting (every eligible leaf, the token
    embedding included): a 1e-7 relative perturbation of the starting
    adapters grows past 1e-2 in one local epoch, so two correct f32
    programs that round differently cannot agree within 1e-5."""
    _, cid, data = _ref_one_client("batched", ())
    base, _ = _oracle((), data, cid)
    moved, _ = _oracle((), data, cid, perturb=1e-7)
    assert _max_diff(base, moved) > 1e-2
    calm, _ = _oracle(ATTN, data, cid)
    calm_moved, _ = _oracle(ATTN, data, cid, perturb=1e-7)
    assert _max_diff(calm, calm_moved) < 1e-5


# ---------------------------------------------------------------------------
# LoRA structure against the reference
# ---------------------------------------------------------------------------


def _glm4_reduced():
    from repro.configs import get_arch as ref_arch
    from repro.models.llm import transformer_lm as ref_lm
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models.llm import transformer_lm as port_lm
    return (ref_lm(ref_arch("glm4-9b", reduced=True)),
            port_lm(port_arch("glm4-9b", reduced=True)))


@pytest.mark.parametrize("targets", [(), ATTN, ("mlp", "unembed")])
@pytest.mark.parametrize("name", ["tiny_lm", "glm4-9b"])
def test_adapter_defs_match_reference(name, targets):
    ref_model, port_model = ((ref_tiny_lm(), port_tiny_lm())
                             if name == "tiny_lm" else _glm4_reduced())
    ref_defs = ref_lora.adapter_defs(ref_model.defs, 4, targets)
    port_defs = port_lora.adapter_defs(port_model.defs, 4, targets)
    assert list(port_defs) == list(ref_defs)
    assert port_lora.target_paths(port_model.defs, targets) == \
        ref_lora.target_paths(ref_model.defs, targets)
    for path, ab in ref_defs.items():
        for f in ("a", "b"):
            assert port_defs[path][f].shape == ab[f].shape, (path, f)
    assert port_lora.adapter_param_count(port_model, 4, targets) == \
        ref_lora.adapter_param_count(ref_model, 4, targets)
    assert port_lora.base_param_count(port_model) == \
        ref_lora.base_param_count(ref_model)


def test_glm4_full_width_adapter_count():
    """The smoke's full-width configuration: GLM-4-9B cut to 2 layers,
    rank 8 on the attention projections -> 401,408 adapter elements."""
    from repro_torch.configs import get_arch
    from repro_torch.models.llm import transformer_lm
    model = transformer_lm(dataclasses.replace(get_arch("glm4-9b"),
                                               n_layers=2))
    assert port_lora.adapter_param_count(model, 8, ATTN) == 401_408


def test_merge_lora_matches_reference():
    model = ref_tiny_lm()
    base = jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(1)))
    defs = ref_lora.adapter_defs(model.defs, 4)
    rs = np.random.RandomState(2)
    adapters = jax.tree_util.tree_map(
        lambda d: (rs.standard_normal(d.shape) * 0.1).astype(np.float32),
        defs, is_leaf=lambda x: hasattr(x, "axes"))
    ref = ref_lora.merge_lora(base, adapters, 4.0)
    got = port_lora.merge_lora(convert.params_from_jax(base),
                               convert.params_from_jax(adapters), 4.0)
    assert _max_diff(convert.params_to_numpy(got), ref) <= 1e-6
    assert port_lora.merge_lora(base, {}, 4.0) is base


def test_fresh_adapters_forward_equals_base_bitwise():
    model = port_tiny_lm()
    base = model.init(torch.Generator().manual_seed(0))
    wrapped = port_lora.lora_wrap(model, base, 4, 16.0)
    adapters = wrapped.init(torch.Generator().manual_seed(1))
    assert all(not bool(ab["b"].any()) for ab in adapters.values())
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 64, (3, 16)).astype(np.int32))
    assert torch.equal(wrapped.apply(adapters, x), model.apply(base, x))


# ---------------------------------------------------------------------------
# the slice: LoRA rounds of the port against the reference
# ---------------------------------------------------------------------------

SLICE = {
    "model": "tiny_lm", "dataset": "tiny_lm",
    "data": {"num_clients": 8, "batch_size": 32},
    "server": {"rounds": 3, "clients_per_round": 4},
    "client": {"local_epochs": 1, "lr": 0.1, "finetune": "lora",
               "lora_rank": 4, "lora_alpha": 8.0,
               "lora_targets": ATTN},
    "resources": {"execution": "batched"},
}


class _InjectedBase(FLModel):
    """``tiny_lm`` whose ``init`` returns given (the reference's) base
    parameters, so the LoRA wrapper freezes the same base."""

    def __init__(self, model, base):
        super().__init__(model.name, model.defs, model.apply,
                         model.num_classes, model.input_shape,
                         model.is_sequence)
        object.__setattr__(self, "_base", base)

    def init(self, gen, device=None):
        return convert.params_from_jax(self._base, device)


def _ref_slice():
    ref_api.reset()
    ref_api.init(SLICE)
    res = ref_api.run()
    ref_api.reset()
    # the reference's trainer draws base and adapters from PRNGKey(seed=0)
    model = ref_tiny_lm()
    base = model.init(jax.random.PRNGKey(0))
    adapters = ref_lora.lora_wrap(
        model, base, 4, 8.0, ATTN).init(
            jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return res, to_np(base), to_np(adapters)


@pytest.fixture(scope="module")
def ref_slice():
    return _ref_slice()


@pytest.mark.parametrize("alpha,calm", [(8.0, True), (16.0, False)])
def test_slice_setting_is_well_conditioned(alpha, calm):
    """3 reference rounds from the reference's start and from it perturbed
    by 1e-7 (relative): alpha 8 (the slice's setting) keeps them within
    1e-6, alpha 16 does not keep them within 1e-5."""
    from repro.core.rounds import Trainer as RefTrainer

    cfg = {**SLICE, "client": {**SLICE["client"], "lora_alpha": alpha}}
    out = []
    for perturb in (0.0, 1e-7):
        ref_api.reset()
        ref_api.init(cfg)
        ctx = ref_api.core.api._ctx
        trainer = RefTrainer(ctx.config, ctx.model, ctx.fed_data,
                             tracker=ctx.tracker)
        trainer.server.params = jax.tree_util.tree_map(
            lambda t: t * (1.0 + perturb),
            trainer.model.init(jax.random.PRNGKey(0)))
        out.append(trainer.run()["params"])
        ref_api.reset()
    moved = _max_diff(*out)
    assert (moved < 1e-6) if calm else (moved > 1e-5)


@pytest.mark.parametrize("flash_on", [False, True])
def test_lora_slice_matches_reference_batched_engine(ref_slice, flash_on):
    ref_res, base, adapters = ref_slice
    repro_torch.reset()
    repro_torch.register_model(_InjectedBase(port_tiny_lm(), base))
    repro_torch.init(SLICE)
    ctx = api._ctx
    trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                      tracker=ctx.tracker)
    trainer.server.params = convert.params_from_jax(adapters)
    port_attention.set_flash_attention(flash_on)
    try:
        res = trainer.run()
    finally:
        port_attention.set_flash_attention(None)
        repro_torch.register_model(port_tiny_lm())
        repro_torch.reset()
    assert sorted(res["params"]) == sorted(ref_res["params"])
    assert _max_diff(convert.params_to_numpy(res["params"]),
                     ref_res["params"]) <= 1e-5
    np.testing.assert_allclose(
        [h["train_loss"] for h in res["history"]],
        [h["train_loss"] for h in ref_res["history"]], rtol=1e-4)
    assert ([h["comm_up_bytes"] for h in res["history"]]
            == [h["comm_up_bytes"] for h in ref_res["history"]])


def test_lora_runs_through_the_public_api_and_counts_adapter_bytes():
    repro_torch.reset()
    repro_torch.init({**SLICE, "server": {"rounds": 2,
                                          "clients_per_round": 3}})
    res = repro_torch.run()
    repro_torch.reset()
    n = port_lora.adapter_param_count(port_tiny_lm(), 4, ATTN)
    assert all(h["comm_up_bytes"] == n * 4 * 3 for h in res["history"])
    assert all(np.isfinite(h["train_loss"]) for h in res["history"])
    assert sum(t.numel() for t in tree_leaves(res["params"])) == n


def test_lora_rejects_no_match_targets_and_runs_the_sequential_engine():
    repro_torch.reset()
    repro_torch.init({**SLICE, "client": {**SLICE["client"],
                                          "lora_targets": ("nothing",)}})
    with pytest.raises(ValueError, match="matched no eligible"):
        repro_torch.run()
    repro_torch.reset()
    repro_torch.init({**SLICE, "server": {"rounds": 1,
                                          "clients_per_round": 2},
                      "resources": {"execution": "sequential"}})
    res = repro_torch.run()
    repro_torch.reset()
    n = port_lora.adapter_param_count(port_tiny_lm(), 4, ATTN)
    assert res["history"][0]["comm_up_bytes"] == n * 4 * 2
    assert np.isfinite(res["history"][0]["train_loss"])
    assert sum(t.numel() for t in tree_leaves(res["params"])) == n
