"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's pure functions, without the reference's 512-device mesh.

* ``model_flops`` equals the reference's for every arch id x shape of
  ``configs/shapes.py``;
* the per-device bytes (params, optimizer state, inputs) equal what the
  reference's own spec functions give — ``models.layers.partition_specs``,
  ``launch.shardings.resolve`` / ``batch_axes_for`` / ``cache_axes_for``
  over its ``Model.input_specs`` — on both production mesh shapes, for
  every arch id x shape and preset;
* ``resolve_spec`` (under an ambient mesh and rule table),
  ``shardings.resolve`` and ``partition_specs`` agree with the reference's
  on every parameter leaf of every arch and every preset's rules;
* the counts extrapolated from three cut depths equal a trace of the
  full depth; the record has the fields the reference's integration test
  asserts (``mesh_shape``, ``roofline.{flops,hbm_bytes,dominant}``,
  ``collectives.total_bytes``), CUDA stays uninitialized, and the
  ``Roofline`` carries the H100's constants;
* ``moe_ffn_expert_parallel`` is ``moe_ffn`` without a mesh, and under a
  mesh with a "model" axis computes what the reference's ``shard_map``
  body computes on each device.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import shardings as ref_shr  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import shardings as shr  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

repro_torch.set_device("cpu")

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_ref_mesh(mesh):
    """What the reference's pure spec functions read off a mesh: axis
    names, ``devices.shape`` and ``shape`` — no device list."""
    shape, names = MESHES[mesh]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=np.int8),
                                 shape=dict(zip(names, shape)))


def _presets(mesh):
    # fsdp_all names "pod", which a single-pod mesh lacks: the reference
    # cannot build its shardings there, so that pair is not compared
    return [p for p in ref_shr.PRESETS
            if not (mesh == "single" and p == "fsdp_all")]


# ---------------------------------------------------------------------------
# model_flops and per-device bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name", list(REF_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_the_reference(arch, shape_name):
    rcfg, shape = ref_get_arch(arch), REF_SHAPES[shape_name]
    want = ref_roofline.model_flops(
        rcfg, shape, text_len=RefModel(rcfg).text_len(shape))
    pshape = SHAPES[shape_name]
    got = roofline.model_flops(get_arch(arch), pshape,
                               text_len=Model(get_arch(arch))
                               .text_len(pshape))
    assert got == want


def _shard_bytes(shape, itemsize, spec, sizes):
    n = itemsize
    for i, dim in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        axes = () if part is None else (part if isinstance(part, tuple)
                                         else (part,))
        div = 1
        for a in axes:
            assert a in sizes, (a, sizes)    # NamedSharding would refuse it
            div *= sizes[a]
        assert dim % div == 0
        n *= dim // div
    return n


def _ref_bytes(arch, shape_name, mesh, preset):
    """The reference's per-device bytes from its own spec functions (the
    arithmetic of ``repro.launch.dryrun._bytes_per_device`` over the
    shardings ``build_state_specs`` / ``batch_shardings`` /
    ``cache_shardings`` make)."""
    model = RefModel(ref_get_arch(arch))
    rules = dict(ref_shr.PRESETS[preset])
    fmesh = _fake_ref_mesh(mesh)
    sizes = fmesh.shape
    defs = jax.tree_util.tree_leaves(
        model.defs(), is_leaf=ref_layers.is_paramdef_leaf)
    pspecs = jax.tree_util.tree_leaves(
        ref_layers.partition_specs(model.defs(), rules, sizes),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    params = sum(_shard_bytes(d.shape, np.dtype(d.dtype).itemsize, s, sizes)
                 for d, s in zip(defs, pspecs))
    shape = REF_SHAPES[shape_name]
    specs = model.input_specs(shape)
    out = {"params": params}
    if shape.kind == "train":
        out["opt_state"] = params + 4
    inputs = 0
    for k, v in specs.items():
        if k == "cache":
            axes = ref_shr.cache_axes_for(v, model.cfg)
            leaves = jax.tree_util.tree_leaves(v)
            axl = jax.tree_util.tree_leaves(
                axes, is_leaf=lambda x: isinstance(x, tuple))
        elif k == "tokens" and "cache" in specs:
            leaves, axl = [v], [("batch", None)]
        elif k == "pos":
            leaves, axl = [v], [()]
        else:
            leaves = [v]
            axl = [ref_shr.batch_axes_for({k: v})[k]]
        for leaf, a in zip(leaves, axl):
            spec = ref_shr.resolve(tuple(a), leaf.shape, rules, fmesh)
            inputs += _shard_bytes(leaf.shape, np.dtype(leaf.dtype).itemsize,
                                   spec, sizes)
    out["inputs"] = inputs
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape_name", list(REF_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_per_device_bytes_match_the_reference(arch, shape_name, mesh):
    pmesh = make_production_mesh(multi_pod=mesh == "multi")
    step = {"train": "train", "prefill": "prefill",
            "decode": "serve"}[SHAPES[shape_name].kind]
    for preset in _presets(mesh):
        got = dryrun.per_device_bytes(
            Model(get_arch(arch)), SHAPES[shape_name], pmesh,
            dict(shr.PRESETS[preset]), step)
        assert got == _ref_bytes(arch, shape_name, mesh, preset), preset


# ---------------------------------------------------------------------------
# spec resolution
# ---------------------------------------------------------------------------


def _p(spec):
    return tuple(spec)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_resolution_matches_the_reference(mesh, monkeypatch):
    shape, names = MESHES[mesh]
    fmesh = _fake_ref_mesh(mesh)
    pmesh = sharding.make_mesh(shape, names)
    monkeypatch.setattr(ref_sharding, "_ambient_mesh", lambda: fmesh)
    checked = 0
    for arch in list_archs():
        rdefs = jax.tree_util.tree_leaves(
            RefModel(ref_get_arch(arch)).defs(),
            is_leaf=ref_layers.is_paramdef_leaf)
        pdefs = tree_flatten(Model(get_arch(arch)).defs())[0]
        assert [tuple(d.axes) for d in pdefs] == \
            [tuple(d.axes) for d in rdefs]
        for preset in list(ref_shr.PRESETS) + ["default"]:
            rules = dict(ref_sharding.DEFAULT_RULES if preset == "default"
                         else ref_shr.PRESETS[preset])
            with ref_sharding.use_rules(rules), sharding.use_rules(rules), \
                    sharding.use_mesh(pmesh):
                for d in pdefs:
                    want = ref_sharding.resolve_spec(tuple(d.axes), d.shape)
                    assert _p(sharding.resolve_spec(tuple(d.axes),
                                                    d.shape)) == _p(want)
                    assert _p(shr.resolve(tuple(d.axes), d.shape, rules,
                                          pmesh)) == \
                        _p(ref_shr.resolve(tuple(d.axes), d.shape, rules,
                                           fmesh))
                    checked += 1
            want = jax.tree_util.tree_leaves(
                ref_layers.partition_specs(
                    RefModel(ref_get_arch(arch)).defs(), rules, fmesh.shape),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got = shr._flat(shr.partition_specs(
                Model(get_arch(arch)).defs(), rules, pmesh.shape), shr.P)
            assert [_p(s) for s in got] == [_p(s) for s in want]
    assert checked > 1000
    assert sharding.current_mesh() is None
    assert sharding.resolve_spec(("embed",)) is None


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layers", [
    ("glm4-9b", 6), ("recurrentgemma-9b", 14), ("deepseek-v2-lite-16b", 6),
    ("whisper-small", 5)])
def test_depth_extrapolation_equals_the_full_trace(arch, layers):
    cfg = dataclasses.replace(get_arch(arch, reduced=True), n_layers=layers)
    if cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    shape = InputShape("t", 32, 2, "train")
    cfgs, n = dryrun.depth_plan(cfg)
    assert n is not None and len(cfgs) == 3
    got, depths = dryrun.counted(cfg, shape, "train")
    p = len(cfg.block_pattern) or 1
    assert depths[2] - depths[1] == depths[1] - depths[0] == p
    assert depths[2] < layers
    want = dryrun.trace_step(Model(cfg), shape, "train")
    assert got["flops"] == want["flops"] > 0
    assert got["hbm_bytes"] == want["hbm_bytes"] > 0


def test_dryrun_single_pod_train_record(tmp_path, capsys):
    rc = dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "train_4k",
                      "--seq-override", "256", "--out", str(tmp_path)])
    assert rc == 0 and "[OK]" in capsys.readouterr().out
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    rec = json.loads(files[0].read_text())
    assert rec["mesh_shape"] == [16, 16]
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["hbm_bytes"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert rec["collectives"]["total_bytes"] > 0     # FSDP gathers exist
    assert rl["card"] == roofline.CARD
    assert rec["device"] == {"cuda_initialized": False, "bytes_allocated": 0}
    assert not torch.cuda.is_initialized()


def test_dryrun_multi_pod_fed_round_record():
    rec = dryrun.dryrun("glm4-9b", "train_4k", multi_pod=True, step="fed",
                        fed_local_steps=2, seq_override=64, out_dir=None)
    assert rec["mesh_shape"] == [2, 16, 16]
    assert rec["step"] == "fed"
    assert rec["roofline"]["collective_bytes"] > 0   # the pod-sync collective
    assert rec["roofline"]["dcn_bytes"] > 0
    assert rec["device"]["cuda_initialized"] is False


def test_roofline_carries_the_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    assert "H100" in roofline.CARD
    for tpu in (ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW):
        assert tpu not in (roofline.PEAK_FLOPS, roofline.HBM_BW,
                           roofline.NVLINK_BW)
    r = roofline.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2,
                          collective_bytes=0.0, chips=1, model_flops=989e12)
    assert r.compute_s == 1.0 and r.memory_s == 0.5
    assert r.dominant == "compute" and r.useful_compute_ratio == 1.0


# ---------------------------------------------------------------------------
# the expert-parallel MoE route
# ---------------------------------------------------------------------------


def _moe_pair(seed=0):
    from repro.core.config import ArchConfig as RA
    from repro.core.config import MoEConfig as RM
    from repro_torch.core.config import ArchConfig, MoEConfig

    def make(arch, moe):
        return arch(name="ep", family="moe", n_layers=1, d_model=16,
                    n_heads=2, n_kv_heads=2, d_ff=32, vocab=32,
                    act="swiglu", moe=moe(n_experts=8, top_k=2,
                                          d_expert=16))
    rs = np.random.RandomState(seed)
    p = {"router": rs.standard_normal((16, 8)).astype(np.float32),
         "w_up": (0.1 * rs.standard_normal((8, 16, 16))).astype(np.float32),
         "w_gate": (0.1 * rs.standard_normal((8, 16, 16))).astype(
             np.float32),
         "w_down": (0.1 * rs.standard_normal((8, 16, 16))).astype(
             np.float32)}
    x = rs.standard_normal((4, 6, 16)).astype(np.float32)
    return make(RA, RM), make(ArchConfig, MoEConfig), p, x


def _ref_expert_parallel(cfg, p, x, n_batch, n_model, factor):
    """The reference's ``shard_map`` body, device by device, from its own
    pieces (``_dispatch_local``, ``_combine_local``, ``load_balance_loss``,
    ``_act``): the all-to-alls move buffers and change no value."""
    from repro.models.mlp import _act
    B, S, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    B_loc = B // n_batch
    T_loc = B_loc * S
    T_my = -(-T_loc // n_model)
    C_my = max(8, -(-int(np.ceil(T_my * k * factor / E)) // 8) * 8)
    outs, auxes = [], []
    for b in range(n_batch):
        xf = jnp.asarray(x[b * B_loc:(b + 1) * B_loc]).reshape(T_loc, d)
        xf = jnp.pad(xf, ((0, T_my * n_model - T_loc), (0, 0)))
        ys = []
        for m in range(n_model):
            x_my = xf[m * T_my:(m + 1) * T_my]
            logits = jnp.einsum("td,de->te", x_my, p["router"])
            probs = jax.nn.softmax(logits, axis=-1)
            top_w, top_ids = jax.lax.top_k(probs, k)
            top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
            auxes.append(ref_moe.load_balance_loss(cfg, probs, top_ids))
            buf, meta = ref_moe._dispatch_local(cfg, x_my, top_w, top_ids,
                                                C_my)
            up = jnp.einsum("ecd,edf->ecf", buf, p["w_up"])
            gate = jnp.einsum("ecd,edf->ecf", buf, p["w_gate"])
            h = _act(cfg.act, gate, up)
            out_buf = jnp.einsum("ecf,efd->ecd", h, p["w_down"])
            ys.append(ref_moe._combine_local(meta, out_buf, T_my))
        outs.append(jnp.concatenate(ys)[:T_loc].reshape(B_loc, S, d))
    return np.asarray(jnp.concatenate(outs)), float(np.mean(auxes))


@pytest.mark.parametrize("mesh_shape,axes,n_batch,n_model", [
    ((2, 2), ("data", "model"), 2, 2),
    ((1, 4), ("data", "model"), 1, 4),
    ((3, 2), ("data", "model"), 1, 2),        # B 4 over 3: replicated
])
def test_expert_parallel_route_is_the_reference_body(mesh_shape, axes,
                                                     n_batch, n_model):
    rcfg, pcfg, p, x = _moe_pair()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    factor = 1.0
    with sharding.use_mesh(sharding.make_mesh(mesh_shape, axes)):
        out, aux = moe_mod.moe_ffn_expert_parallel(pcfg, tp, tx, factor)
    want_out, want_aux = _ref_expert_parallel(rcfg, p, x, n_batch, n_model,
                                              factor)
    assert np.abs(out.numpy() - want_out).max() <= 1e-6
    assert abs(float(aux) - want_aux) <= 1e-6
    # no mesh: the global route, bit for bit
    g_out, g_aux = moe_mod.moe_ffn(pcfg, tp, tx, factor)
    n_out, n_aux = moe_mod.moe_ffn_expert_parallel(pcfg, tp, tx, factor)
    assert torch.equal(g_out, n_out) and torch.equal(g_aux, n_aux)
