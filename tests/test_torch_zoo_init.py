"""The trained zoo archs' default init at their published depth, in the
reference and in the port: why ``chip_smoke.py``'s phase 4m trains
PaliGemma and Whisper from a well-conditioned redraw of
``launch.train``'s init.

At reduced width (``reduced()``: d_model 256, 4 heads of 32) and the
published depth (PaliGemma 18 layers, Whisper 12 + 12), from each
package's own default init (the reference's ``Model.init`` at PRNGKey 0,
the port's at generator seed 0, as ``launch.train`` draws it), with
N(0, 1) frames, the gradient of the loss explodes with depth and is not
determined by float32 params, in both packages alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_unflatten  # noqa: E402

repro_torch.set_device("cpu")

#: the published depths of the trained VLM and audio archs
DEEP = {"paligemma-3b": {"n_layers": 18},
        "whisper-small": {"n_layers": 12, "encoder_layers": 12}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module, as the other training files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **changes):
    """(reference, port) reduced configs of ``arch`` with ``changes``."""
    return (dataclasses.replace(ref_arch(arch, reduced=True), **changes),
            dataclasses.replace(port_arch(arch, reduced=True), **changes))


def _batch(cfg, B, S, seed):
    """tokens (B, S) and N(0, 1) frames (B, F, d_model) from a numpy
    seed."""
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32),
            "frames": rs.standard_normal(
                (B, cfg.n_frames, cfg.d_model)).astype(np.float32)}


def _grad_scale(loss_grad, params, perturb):
    """(max |grad|, max |grad(params) - grad(params x (1 + 1e-7 N(0,
    1)))|) over every leaf; ``perturb(params)`` draws the perturbed
    params."""
    g, g2 = loss_grad(params), loss_grad(perturb(params))
    return (max(float(np.abs(a).max()) for a in g),
            max(float(np.abs(a - b).max()) for a, b in zip(g, g2)))


def _ref_grad_scale(rc, batch):
    batch = jax.tree_util.tree_map(jnp.asarray, batch)
    fn = jax.jit(jax.grad(lambda p: RefModel(rc).loss(p, batch)[0]))

    def perturb(p):
        leaves, tdef = jax.tree_util.tree_flatten(p)
        keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
        return tdef.unflatten([x * (1 + 1e-7 * jax.random.normal(k, x.shape))
                               for x, k in zip(leaves, keys)])
    return _grad_scale(
        lambda p: [np.asarray(a) for a in jax.tree_util.tree_leaves(fn(p))],
        RefModel(rc).init(jax.random.PRNGKey(0)), perturb)


def _port_grad_scale(pc, batch):
    model = Model(pc)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def grads(p):
        leaves, tdef = tree_flatten(p)
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        model.loss(tree_unflatten(tdef, leaves), batch)[0].backward()
        return [t.grad.numpy() for t in leaves]

    def perturb(p):
        gen = torch.Generator().manual_seed(7)
        leaves, tdef = tree_flatten(p)
        return tree_unflatten(tdef, [
            t * (1 + 1e-7 * torch.randn(t.shape, generator=gen))
            for t in leaves])
    return _grad_scale(grads, model.init(torch.Generator().manual_seed(0),
                                         torch.device("cpu")), perturb)


@pytest.mark.parametrize("arch", list(DEEP))
def test_default_init_is_ill_conditioned_at_full_depth_in_both_packages(
        arch):
    """In each package, at the published depth max |grad| is over 1e3
    times its 2-layer value, and a 1e-7 relative perturbation of the
    params moves the gradient by more than half its own size, where at 2
    layers it moves it by under 5%.  So at full depth one step of the
    driver's SGD (lr 3e-2, momentum 0.9) moves the params by thousands, no
    two runs track each other past it, and the step at which a run first
    goes non-finite depends on rounding, not on either package."""
    shallow = {k: 2 for k in DEEP[arch]}
    scales = {}
    for depth, changes in (("shallow", shallow), ("full", DEEP[arch])):
        rc, pc = _cfgs(arch, **changes)
        batch = _batch(rc, 2, 32, 1)
        scales[depth] = {"reference": _ref_grad_scale(rc, batch),
                         "port": _port_grad_scale(pc, batch)}
    for pkg in ("reference", "port"):
        (g2, r2), (gf, rf) = scales["shallow"][pkg], scales["full"][pkg]
        assert gf >= 1e3 * g2, (pkg, scales)
        assert r2 <= 0.05 * g2, (pkg, scales)
        assert rf >= 0.5 * gf, (pkg, scales)
    print(f"{arch}: (max |grad|, its move under a 1e-7 perturbation) "
          f"{scales}")
