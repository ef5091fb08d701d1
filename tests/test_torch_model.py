"""Models and optimizers of the port against the reference, with the
reference's initial parameters injected and numpy-made batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.models import small as ref_small  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import small as port_small  # noqa: E402
from repro_torch.optim import optimizers as port_opt  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

repro_torch.set_device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(name):
    if name == "femnist_cnn":
        return ref_small.femnist_cnn(), port_small.femnist_cnn(), (8, 784), 62
    return ref_small.linear_model(), port_small.linear_model(), (8, 64), 10


@pytest.mark.parametrize("name", ["femnist_cnn", "linear"])
def test_forward_loss_accuracy_and_grads_match(name):
    ref_m, port_m, xshape, classes = _models(name)
    rs = np.random.RandomState(0)
    p_np = jax.tree_util.tree_map(
        np.asarray, ref_m.init(jax.random.PRNGKey(3)))
    x = rs.standard_normal(xshape).astype(np.float32)
    y = rs.randint(0, classes, size=(8,)).astype(np.int32)
    p_t = convert.params_from_jax(p_np)
    # same leaf order and shapes (jax.tree_util order = sorted keys)
    assert [a.shape for a in jax.tree_util.tree_leaves(p_np)] == \
        [tuple(t.shape) for t in tree_leaves(p_t)]
    assert tree_paths(p_t) == sorted(tree_paths(p_t))

    np.testing.assert_allclose(
        ref_m.apply(p_np, jnp.asarray(x)),
        port_m.apply(p_t, torch.from_numpy(x)).numpy(), **TOL)

    def ref_loss(p):
        return ref_m.loss_and_metrics(p, {"x": jnp.asarray(x),
                                          "y": jnp.asarray(y)})
    (rl, rm), rg = jax.value_and_grad(ref_loss, has_aux=True)(p_np)

    def port_loss(p):
        loss, m = port_m.loss_and_metrics(
            p, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        return loss, m
    pg, (pl, pm) = torch.func.grad_and_value(port_loss, has_aux=True)(p_t)
    np.testing.assert_allclose(float(rl), float(pl), **TOL)
    assert float(rm["accuracy"]) == float(pm["accuracy"])
    for a, b in zip(jax.tree_util.tree_leaves(rg), tree_leaves(pg)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def test_default_init_shapes_and_param_count():
    p = port_small.femnist_cnn().init(torch.Generator().manual_seed(0))
    ref = ref_small.femnist_cnn().init(jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tree_leaves(p)] == \
        [a.shape for a in jax.tree_util.tree_leaves(ref)]
    assert sum(t.numel() for t in tree_leaves(p)) == 6_603_710
    # deterministic in the seed, independent of the device it lands on
    again = port_small.femnist_cnn().init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))


HETERO = {
    "sgd": [dict(lr=0.1, momentum=0.9, weight_decay=0.0, nesterov=0.0),
            dict(lr=0.05, momentum=0.5, weight_decay=1e-3, nesterov=1.0),
            dict(lr=0.2, momentum=0.0, weight_decay=0.0, nesterov=0.0)],
    "adamw": [dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0),
              dict(lr=3e-3, b1=0.8, b2=0.99, eps=1e-6, weight_decay=1e-2),
              dict(lr=1e-2, b1=0.5, b2=0.9, eps=1e-7, weight_decay=0.0)],
}


@pytest.mark.parametrize("family", ["sgd", "adamw"])
def test_traced_optimizers_match_per_step_with_hetero_hparams(family):
    rows = HETERO[family]
    if family == "sgd":
        ref_o, port_o = ref_opt.sgd_traced(True, True), \
            port_opt.sgd_traced(True, True)
        ref_hp_cls, port_hp_cls = ref_opt.SGDHParams, port_opt.SGDHParams
    else:
        ref_o, port_o = ref_opt.adamw_traced(), port_opt.adamw_traced()
        ref_hp_cls, port_hp_cls = ref_opt.AdamWHParams, port_opt.AdamWHParams
    fields = ref_hp_cls._fields
    hp_np = {f: np.asarray([r[f] for r in rows], np.float32) for f in fields}
    ref_hp = ref_hp_cls(*(jnp.asarray(hp_np[f]) for f in fields))
    port_hp = port_hp_cls(*(torch.from_numpy(hp_np[f]) for f in fields))

    rs = np.random.RandomState(1)
    n = len(rows)
    params = {"a": {"w": rs.standard_normal((n, 5, 3)).astype(np.float32)},
              "b": rs.standard_normal((n, 4)).astype(np.float32)}
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = convert.params_from_jax(params)
    rstate = jax.vmap(ref_o.init)(rp, ref_hp)
    pstate = torch.func.vmap(port_o.init)(pp, port_hp)
    for step in range(4):
        g = jax.tree_util.tree_map(
            lambda a: rs.standard_normal(a.shape).astype(np.float32), params)
        ru, rstate = jax.vmap(ref_o.update)(
            jax.tree_util.tree_map(jnp.asarray, g), rstate, rp, ref_hp)
        pu, pstate = torch.func.vmap(port_o.update)(
            convert.params_from_jax(g), pstate, pp, port_hp)
        rp = ref_opt.apply_updates(rp, ru)
        pp = port_opt.apply_updates(pp, pu)
        for a, b in zip(jax.tree_util.tree_leaves(rp), tree_leaves(pp)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"step {step}")


def test_global_norm_matches():
    rs = np.random.RandomState(2)
    tree = {"x": rs.standard_normal((3, 4)).astype(np.float32),
            "y": rs.standard_normal((7,)).astype(np.float32)}
    np.testing.assert_allclose(
        float(ref_opt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
        float(port_opt.global_norm(convert.params_from_jax(tree))),
        rtol=1e-6)
