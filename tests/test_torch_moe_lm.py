"""A MoE ``transformer_lm`` in the port's engines, against the reference.

* ``transformer_lm`` of a MoE arch builds (Qwen3-30B-A3B at its published
  width, its parameter tree equal to the reference's) and its ``apply``
  keeps the logits and drops the aux loss;
* the dispatch the batched engine runs under ``torch.func.vmap`` (the
  per-expert counts as a one-hot sum, the inverse permutation as
  ``argsort``, the buffer from an out-of-place ``index_put``) is bitwise
  the per-client ``bincount`` / in-place form it replaced — outputs, aux
  and gradients, for one client and for a vmapped cohort, in a case that
  drops assignments at capacity;
* a reduced ``qwen3-moe-30b-a3b`` trains 2 rounds of 4 clients through the
  sequential and the batched engine, with and without LoRA, within 1e-5
  of the reference's params and 1e-4 of its train loss, from the
  reference's initial params injected through ``repro_torch.convert``.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro as ref_api  # noqa: E402
import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.rounds import Trainer as RefTrainer  # noqa: E402
from repro.models import lora as ref_lora  # noqa: E402
from repro.models.llm import transformer_lm as ref_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.rounds import Trainer  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.llm import transformer_lm  # noqa: E402
from repro_torch.models.small import FLModel  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

repro_torch.set_device("cpu")

ARCH = "qwen3-moe-30b-a3b"
ATTN = ("attn",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and
    under a loaded parallel test run torch's thread pool made such runs
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_moe_transformer_lm_builds_at_published_width():
    model = transformer_lm(get_arch(ARCH))
    ref = ref_lm(ref_get_arch(ARCH))
    leaves = tree_flatten(model.defs)[0]
    ref_leaves = jax.tree_util.tree_leaves(
        ref.defs, is_leaf=lambda x: hasattr(x, "axes"))
    assert [tuple(d.shape) for d in leaves] == \
        [tuple(d.shape) for d in ref_leaves]
    assert [tuple(d.axes) for d in leaves] == \
        [tuple(d.axes) for d in ref_leaves]
    n = sum(int(np.prod(d.shape)) for d in leaves)
    assert n == sum(int(np.prod(d.shape)) for d in ref_leaves)
    assert model.is_sequence and model.num_classes == 151936


def test_moe_apply_drops_the_aux_loss():
    arch = get_arch(ARCH, reduced=True)
    model = transformer_lm(arch)
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, arch.vocab, (2, 16)).astype(np.int32))
    logits = model.apply(params, x)
    from repro_torch.models import transformer
    want, aux = transformer.forward(arch, params, x)
    assert torch.equal(logits, want)
    assert aux.dim() == 0 and float(aux) > 0


# ---------------------------------------------------------------------------
# the vmappable dispatch against the per-client form it replaced
# ---------------------------------------------------------------------------


def _dispatch_bincount(cfg, x_flat, top_w, top_ids, C):
    """The per-client dispatch the port ran before: ``bincount`` counts."""
    m = cfg.moe
    T, d = x_flat.shape
    k, E = m.top_k, m.n_experts
    flat_e = top_ids.reshape(T * k)
    flat_w = top_w.reshape(T * k).to(x_flat.dtype)
    order = torch.argsort(flat_e, stable=True)
    sorted_e, sorted_w = flat_e[order], flat_w[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k) - starts[sorted_e]
    keep = pos < C
    pos_c = torch.where(keep, pos, C)
    src = x_flat.unsqueeze(1).expand(T, k, d).reshape(T * k, d)[order]
    buf = x_flat.new_zeros((E, C + 1, d)).index_put((sorted_e, pos_c), src)
    return buf[:, :C], (order, sorted_e, sorted_w, pos_c, keep)


def _combine_inplace(meta, out_buf, T):
    """The per-client combine the port ran before: the inverse permutation
    written in place."""
    order, sorted_e, sorted_w, pos_c, keep = meta
    E, C, d = out_buf.shape
    k = order.numel() // T
    gathered = out_buf[sorted_e, torch.clamp_max(pos_c, C - 1)]
    gathered = gathered * (sorted_w * keep.to(out_buf.dtype))[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel())
    per_token = gathered[inv.view(T, k).sort(dim=1).values]
    out = per_token[:, 0]
    for j in range(1, k):
        out = out + per_token[:, j]
    return out


def _moe_with(cfg, p, x, dispatch, combine, factor):
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    top_w, top_ids, probs = moe_mod._router(cfg, p, xf)
    counts = torch.stack([(top_ids == e).sum() for e in
                          range(cfg.moe.n_experts)])
    f = counts.to(torch.float32) / (T * cfg.moe.top_k)
    aux = cfg.moe.n_experts * torch.sum(f * probs.mean(dim=0))
    C = moe_mod.capacity(cfg, T, factor)
    buf, meta = dispatch(cfg, xf, top_w, top_ids, C)
    out = combine(meta, moe_mod._experts(cfg, p, buf), T)
    return out.reshape(B, S, d), aux


def _moe_case(seed=0):
    from repro_torch.core.config import ArchConfig, MoEConfig
    cfg = ArchConfig(
        name="moe-dispatch", family="moe", n_layers=1, d_model=16,
        n_heads=2, n_kv_heads=2, d_ff=32, vocab=32, act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=16))
    g = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn(16, 8, generator=g) * 2.0,
         "w_up": torch.randn(8, 16, 16, generator=g) * 0.1,
         "w_gate": torch.randn(8, 16, 16, generator=g) * 0.1,
         "w_down": torch.randn(8, 16, 16, generator=g) * 0.1}
    x = torch.randn(3, 2, 12, 16, generator=g)       # 3 clients
    return cfg, p, x


def test_vmappable_dispatch_is_bitwise_the_per_client_one():
    cfg, p, x = _moe_case()
    factor = 0.5            # capacity 8 for 48 assignments: drops
    dropped = 0
    for i in range(x.shape[0]):
        T = x.shape[1] * x.shape[2]
        _, top_ids, _ = moe_mod._router(cfg, p, x[i].reshape(T, -1))
        counts = torch.bincount(top_ids.reshape(-1), minlength=8)
        assert torch.equal(moe_mod._expert_counts(top_ids.reshape(-1), 8),
                           counts)
        dropped += int((counts - moe_mod.capacity(cfg, T, factor))
                       .clamp_min(0).sum())
    assert dropped > 0

    def loss(params, xx, new):
        if new:
            o, a = moe_mod.moe_ffn(cfg, params, xx, factor)
        else:
            o, a = _moe_with(cfg, params, xx, _dispatch_bincount,
                             _combine_inplace, factor)
        return (o ** 2).sum() + a

    vo, va = torch.func.vmap(
        lambda xx: moe_mod.moe_ffn(cfg, p, xx, factor))(x)
    vg = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0, None))(
        p, x, True)
    for i in range(x.shape[0]):
        want_o, want_a = _moe_with(cfg, p, x[i], _dispatch_bincount,
                                   _combine_inplace, factor)
        got_o, got_a = moe_mod.moe_ffn(cfg, p, x[i], factor)
        assert torch.equal(got_o, want_o) and torch.equal(got_a, want_a)
        assert torch.equal(vo[i], want_o) and torch.equal(va[i], want_a)
        want_g = torch.func.grad(loss)(p, x[i], False)
        for k in want_g:
            assert torch.equal(vg[k][i], want_g[k]), k
            assert torch.equal(torch.func.grad(loss)(p, x[i], True)[k],
                               want_g[k]), k


# ---------------------------------------------------------------------------
# 2 rounds through the engines against the reference
# ---------------------------------------------------------------------------


def _cfg(execution, lora):
    client = {"local_epochs": 1, "lr": 0.1}
    if lora:
        client.update(finetune="lora", lora_rank=4, lora_alpha=8.0,
                      lora_targets=ATTN)
    return {"model": get_arch(ARCH, reduced=True).name,
            "dataset": "tiny_lm",
            "data": {"num_clients": 8, "batch_size": 32},
            "server": {"rounds": 2, "clients_per_round": 4},
            "client": client, "resources": {"execution": execution}}


class _Injected(FLModel):
    """The port's model whose ``init`` returns given (the reference's)
    parameters, so a LoRA wrapper freezes the reference's base."""

    def __init__(self, model, params):
        super().__init__(model.name, model.defs, model.apply,
                         model.num_classes, model.input_shape,
                         model.is_sequence)
        object.__setattr__(self, "_params", params)

    def init(self, gen, device=None):
        return convert.params_from_jax(self._params, device)


_REF = {}


def _ref_run(execution, lora):
    """The reference's run of the configuration and its starting params
    (base, and the adapters under LoRA), from its ``PRNGKey(seed=0)``."""
    key = (execution, lora)
    if key not in _REF:
        model = ref_lm(ref_get_arch(ARCH, reduced=True))
        ref_api.reset()
        ref_api.register_model(model)
        ref_api.init(_cfg(execution, lora))
        ctx = ref_api.core.api._ctx
        trainer = RefTrainer(ctx.config, ctx.model, ctx.fed_data,
                             tracker=ctx.tracker)
        try:
            res = trainer.run()
        finally:
            ref_api.reset()
        base = model.init(jax.random.PRNGKey(0))
        start = base
        if lora:
            start = ref_lora.lora_wrap(model, base, 4, 8.0, ATTN).init(
                jax.random.PRNGKey(0))
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        _REF[key] = (res, to_np(base), to_np(start))
    return _REF[key]


@pytest.mark.parametrize("execution,lora", [
    ("sequential", False), ("batched", False), ("sequential", True),
    ("batched", True)])
def test_moe_lm_rounds_match_the_reference(execution, lora):
    ref_res, base, start = _ref_run(execution, lora)
    port_model = transformer_lm(get_arch(ARCH, reduced=True))
    repro_torch.reset()
    repro_torch.register_model(_Injected(port_model, base))
    try:
        repro_torch.init(_cfg(execution, lora))
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        trainer.server.params = convert.params_from_jax(start)
        res = trainer.run()
    finally:
        repro_torch.reset()
    got = convert.params_to_numpy(res["params"])
    assert len(jax.tree_util.tree_leaves(got)) == \
        len(jax.tree_util.tree_leaves(ref_res["params"]))
    assert _max_diff(got, ref_res["params"]) <= 1e-5
    np.testing.assert_allclose(
        [h["train_loss"] for h in res["history"]],
        [h["train_loss"] for h in ref_res["history"]], rtol=1e-4)
    assert ([h["comm_up_bytes"] for h in res["history"]]
            == [h["comm_up_bytes"] for h in ref_res["history"]])


def test_moe_lm_full_width_lora_adapter_count():
    """Phase 4n's configuration: Qwen3-30B-A3B at its published width cut
    to 2 layers, rank 8 on the attention projections."""
    from repro.models.llm import transformer_lm as rlm
    from repro_torch.models import lora as port_lora
    model = transformer_lm(dataclasses.replace(get_arch(ARCH), n_layers=2))
    ref = rlm(dataclasses.replace(ref_get_arch(ARCH), n_layers=2))
    assert port_lora.adapter_param_count(model, 8, ATTN) == \
        ref_lora.adapter_param_count(ref, 8, ATTN)
    assert port_lora.base_param_count(model) == \
        ref_lora.base_param_count(ref)
