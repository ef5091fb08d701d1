"""The serve step with its position on the device: the port's counterpart
of the reference's ``jax.jit(make_serve_step(model, ring=...),
donate_argnums=(1,))``, whose ``pos`` is a traced ``int32``.

For every arch id at reduced size (RecurrentGemma at 3 layers, so that its
local attention's ring is present), with a linear and a ring cache, over
positions 0-11 (a linear cache of 12 slots; rings of 8 slots, so 7 is the
window edge and 8-11 wrap):

* ``decode_step`` with a 0-d tensor ``pos`` is bit for bit the Python-int
  path (logits and caches);
* the port's stepwise decode with a tensor ``pos`` matches the reference's
  jitted serve step at ``tests/test_torch_serve.py``'s tolerance (1e-4),
  and that jitted step has compiled once for all twelve positions
  (``_cache_size() == 1``): the contract the port's one capture ports;
* ``analysis.contracts.HostSyncMode`` finds no op in the step that makes
  the host wait for the device;
* on the CPU the step runs eagerly and counts no capture.

The capture logic itself (warm-up, one capture, replays, a recapture on a
new cache or new params, one graph a step object) runs here with a
recording graph in place of the CUDA one (``_RecordedGraph``); the card
tests in ``tests/test_torch_cuda.py`` run the real graph.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models.layers import is_paramdef_leaf  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.model import make_serve_step as ref_serve_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis.contracts import HostSyncMode  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import Model, make_serve_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

repro_torch.set_device("cpu")

B, STEPS, LENGTH, WINDOW = 2, 12, 12, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and under
    a loaded parallel test run torch's thread pool made such runs many
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(reference, port) reduced configs: rings of ``WINDOW`` slots (the
    ring cache's ``decode_window``, local attention's ``window``);
    RecurrentGemma at 3 layers (rglru, rglru, local_attn)."""
    changes = {"decode_window": WINDOW, "window": WINDOW}
    if arch == "recurrentgemma-9b":
        changes["n_layers"] = 3
    return (dataclasses.replace(ref_arch(arch, reduced=True), **changes),
            dataclasses.replace(port_arch(arch, reduced=True), **changes))


def _params(cfg, seed=3):
    """numpy parameters at a well-conditioned scale (matrices std
    1/sqrt(d_model), vectors 0.1), as ``tests/test_torch_zoo.py``."""
    rs = np.random.RandomState(seed)

    def draw(d):
        lead = 1 if d.axes and d.axes[0] == "layers" else 0
        std = cfg.d_model ** -0.5 if len(d.shape) - lead >= 2 else 0.1
        return (rs.standard_normal(d.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map(draw, RefModel(cfg).defs(),
                                  is_leaf=is_paramdef_leaf)


def _ref_cache(rc, ring):
    """The reference's zero cache; an encoder-decoder's ``enc_kv``
    non-zero (from a numpy seed)."""
    cache = RefModel(rc).init_cache(B, LENGTH, ring=ring)
    if rc.encoder_layers:
        rs = np.random.RandomState(5)
        cache["enc_kv"] = {k: jnp.asarray(rs.standard_normal(
            v.shape).astype(np.float32)) for k, v in cache["enc_kv"].items()}
    return cache


def _port_cache(ref_cache):
    return convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_cache), "cpu")


def _tokens(vocab, seed=2):
    return np.random.RandomState(seed).randint(0, vocab, (B, STEPS)).astype(
        np.int32)


def _decode(step, params, cache, toks, as_tensor):
    """Steps 0..STEPS-1 -> (per-step logits, the cache)."""
    out = []
    for t in range(STEPS):
        pos = torch.tensor(t, dtype=torch.int32) if as_tensor else t
        lg, cache = step(params, cache, torch.from_numpy(toks[:, t:t + 1]),
                         pos)
        out.append(lg)
    return out, cache


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
@pytest.mark.parametrize("arch", list_archs())
def test_tensor_position_step_is_the_int_path_and_the_reference(arch, ring):
    rc, pc = _cfgs(arch)
    params = _params(rc)
    tp = convert.params_from_jax(params, "cpu")
    toks = _tokens(rc.vocab)
    ref_cache = _ref_cache(rc, ring)
    model = Model(pc)

    step = make_serve_step(model, ring=ring)
    n0 = model_mod.serve_capture_count(), model_mod.serve_replay_count()
    by_int, int_cache = _decode(step, tp, _port_cache(ref_cache), toks, False)
    by_tensor, cache = _decode(step, tp, _port_cache(ref_cache), toks, True)
    # the CPU runs every step eagerly: no graph, no capture
    assert (step.captures, step.recaptures, step.replays,
            step.eager_steps) == (0, 0, 0, 2 * STEPS)
    assert (model_mod.serve_capture_count(),
            model_mod.serve_replay_count()) == n0
    for a, b in zip(by_int + tree_leaves(int_cache),
                    by_tensor + tree_leaves(cache)):
        assert torch.equal(_bits(a), _bits(b))

    ref_step = jax.jit(ref_serve_step(RefModel(rc), ring=ring))
    for t in range(STEPS):
        rl, ref_cache = ref_step(params, ref_cache, toks[:, t:t + 1],
                                 jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(by_tensor[t].numpy(), np.asarray(rl),
                                   rtol=1e-4, atol=1e-4)
    assert ref_step._cache_size() == 1     # one program for every position
    ref_leaves = jax.tree_util.tree_leaves(ref_cache)
    assert len(ref_leaves) == len(tree_leaves(cache))
    for got, want in zip(tree_leaves(cache), ref_leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    # the last position once more (a wrap of every ring), with nothing
    # that waits on the device: no scalar read, no data-dependent shape, no
    # copy to the host
    with HostSyncMode() as mode:
        step(tp, cache, torch.from_numpy(toks[:, -1:]),
             torch.tensor(STEPS - 1, dtype=torch.int32))
    assert mode.found == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slot", [0, 7, 11])
def test_write_slot_and_positions_are_the_host_int_forms(slot, dtype):
    """The device forms are bit for bit the host-int forms they replace:
    ``write_slot`` with a tensor slot (``index_copy_``) against a slice
    write, and the decode positions (a view of the 0-d position) against
    ``torch.full((B, 1), pos)``, dtype included."""
    from repro_torch.models import kvcache as kvc
    from repro_torch.models import transformer as tfm

    gen = torch.Generator().manual_seed(slot)
    cache = torch.randn((B, LENGTH, 2, 4), generator=gen).to(dtype)
    new = torch.randn((B, 1, 2, 4), generator=gen)
    want = cache.clone()
    want[:, slot:slot + 1] = new.to(dtype)
    got = kvc.write_slot(cache, new, torch.tensor(slot, dtype=torch.int32))
    assert got is cache and torch.equal(_bits(got), _bits(want))
    positions = tfm._positions(kvc.as_pos(torch.tensor(slot)), B)
    full = torch.full((B, 1), slot)
    assert positions.dtype == full.dtype and torch.equal(positions, full)


def test_host_sync_mode_sees_a_host_read_of_the_position():
    """The witness for the check above: reading a tensor position on the
    host, as the step once did (``int(pos)``), is what it flags."""
    with HostSyncMode() as mode:
        int(torch.tensor(5, dtype=torch.int32))
    assert mode.found == ["aten._local_scalar_dense"]


# ---------------------------------------------------------------------------
# the capture logic, with a recording graph in place of the CUDA one
# ---------------------------------------------------------------------------


class _RecordedGraph:
    """Stands in for ``utils.capture.CapturedGraph`` on the CPU: keeps
    static copies of the inputs; each call copies the call's inputs into
    them (``copy_`` or ``fill_``, as a replay) and runs the captured
    function on them, returning a copy of its output."""
    made = []

    def __init__(self, run, inputs, device, counts):
        self.run = run
        self.static = [t.clone() for t in inputs]
        self.calls = 0
        self.counts = counts
        counts.captures += 1
        _RecordedGraph.made.append(self)

    def __call__(self, inputs):
        for buf, t in zip(self.static, inputs):
            if isinstance(t, torch.Tensor):
                buf.copy_(t)
            else:
                buf.fill_(t)
        self.calls += 1
        self.counts.replays += 1
        return self.run(self.static).clone()


@pytest.fixture()
def recorded(monkeypatch):
    monkeypatch.setattr(model_mod, "CapturedGraph", _RecordedGraph)
    monkeypatch.setattr(_RecordedGraph, "made", [])
    monkeypatch.setattr(model_mod.ServeStep, "graph_device_types", ("cpu",))
    return _RecordedGraph.made


@pytest.mark.parametrize("arch,ring", [
    ("glm4-9b", True), ("rwkv6-1.6b", False), ("deepseek-v2-lite-16b", True),
    ("whisper-small", False), ("recurrentgemma-9b", False)])
def test_one_capture_serves_every_position(recorded, arch, ring):
    """The first call eager (the warm-up), the second captures, every later
    call replays the one graph, int and tensor positions alike, bit for bit
    the eager step; the cache comes back as the caller's object."""
    rc, pc = _cfgs(arch)
    tp = convert.params_from_jax(_params(rc), "cpu")
    toks = _tokens(rc.vocab)
    ref_cache = _ref_cache(rc, ring)
    model = Model(pc)
    eager = make_serve_step(model, ring=ring, capture=False)
    want, want_cache = _decode(eager, tp, _port_cache(ref_cache), toks, True)
    step = make_serve_step(model, ring=ring)
    cache = _port_cache(ref_cache)
    n0 = model_mod.serve_capture_count(), model_mod.serve_replay_count()
    got = []
    for t in range(STEPS):
        pos = t if t % 2 else torch.tensor(t, dtype=torch.int32)
        lg, out = step(tp, cache, torch.from_numpy(toks[:, t:t + 1]), pos)
        assert out is cache
        got.append(lg)
    assert (step.eager_steps, step.captures, step.recaptures,
            step.replays) == (1, 1, 0, STEPS - 1)
    assert (model_mod.serve_capture_count() - n0[0],
            model_mod.serve_replay_count() - n0[1]) == (1, STEPS - 1)
    assert len(recorded) == 1 and recorded[0].calls == STEPS - 1
    for a, b in zip(got + tree_leaves(cache), want + tree_leaves(want_cache)):
        assert torch.equal(_bits(a), _bits(b))
    assert (eager.captures, eager.replays, eager.eager_steps) == (0, 0, STEPS)


def test_a_new_cache_or_new_params_recapture(recorded):
    """The graph reads the params and writes the cache in their own
    storage, so another cache or other params capture again at once (no
    second warm-up), and the step keeps one graph; a new token shape warms
    up first."""
    rc, pc = _cfgs("glm4-9b")
    tp = convert.params_from_jax(_params(rc), "cpu")
    model = Model(pc)
    step = make_serve_step(model)
    tok = torch.from_numpy(_tokens(rc.vocab)[:, :1])

    def fresh():
        return model.init_cache(B, LENGTH, device="cpu")
    cache = fresh()
    for t in range(3):
        step(tp, cache, tok, t)                     # warm-up, capture, replay
    assert (step.eager_steps, step.captures, step.recaptures) == (1, 1, 0)
    step(tp, fresh(), tok, 0)                       # a new cache
    assert (step.captures, step.recaptures) == (2, 1)
    tp2 = convert.params_from_jax(_params(rc, seed=4), "cpu")
    lg, _ = step(tp2, cache, tok, 3)                # new params
    assert (step.captures, step.recaptures, step.eager_steps) == (3, 2, 1)
    # the same slot rewritten with the same values: the eager step's logits
    want, _ = make_serve_step(model, capture=False)(tp2, cache, tok, 3)
    assert step._graph[2] is recorded[-1] and len(recorded) == 3
    step(tp2, model.init_cache(2 * B, LENGTH, device="cpu"),
         tok.repeat(2, 1), 0)                       # a new token shape
    assert (step.captures, step.eager_steps) == (3, 2)
    assert step.replays == 4
    np.testing.assert_array_equal(lg.numpy(), want.numpy())
