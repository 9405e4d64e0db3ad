"""Gradient accumulation (`make_optimizer(grad_accum=k)`, the counterpart
of optax.MultiSteps) and the learning-rate tree's per-cage overrides and
frozen paths, against the JAX package on the CPU. The first two tests are
tests/test_chain.py's `TestGradAccum`, in the port's API (the optimizer
updates the parameters in place; an update's size is read off the
parameters).

Tolerances: rtol 1e-6 (tests/test_chain.py's), atol 1e-7 against optax
(tests/test_torch_train.py's: optax takes Adam's bias corrections in
float32, torch.optim.Adam in double); the learning rates exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3ga_tpu.model.avatar import init_avatar as j_init_avatar
from d3ga_tpu.train.optim import lr_tree_from_config as j_lr_tree
from d3ga_tpu.train.optim import make_optimizer as j_make_optimizer
from d3ga_tpu_torch.model.avatar import init_avatar
from d3ga_tpu_torch.train.optim import lr_tree_from_config, make_optimizer
from d3ga_tpu_torch.utils.tree import tree_leaves
from torch_options import cage_pair, mesh_pair


def test_two_microsteps_equal_mean_grad_update():
    g1 = [torch.tensor([1.0, -2.0, 0.5, 0.0])]
    g2 = [torch.tensor([3.0, 0.0, -0.5, 1.0])]
    gm = [(a + b) / 2 for a, b in zip(g1, g2)]

    # reference: one update with the mean gradient
    ref = {"w": torch.arange(4.0)}
    make_optimizer(ref, {"w": 0.1}).step(gm)

    # accumulating optimizer: two micro-steps, the update on the 2nd
    params = {"w": torch.arange(4.0)}
    tx = make_optimizer(params, {"w": 0.1}, grad_accum=2)
    before = params["w"].detach().clone()
    assert tx.step(g1) is None
    # the first micro-step changes neither the parameters nor Adam's state
    assert torch.equal(params["w"].detach(), before) and not tx.opt.state
    assert tx.step(g2) is not None
    np.testing.assert_allclose(params["w"].detach().numpy(), ref["w"].detach().numpy(), rtol=1e-6)
    assert (tx.count, tx.micro) == (1, 2)


def test_milestones_stay_in_iteration_units():
    def fired_magnitudes(grad_accum, n_micro):
        params = {"w": torch.zeros(2)}
        tx = make_optimizer(params, {"w": 1.0}, milestones=[4], gamma=0.5, grad_accum=grad_accum)
        mags = []
        for _ in range(n_micro):
            before = params["w"].detach().clone()
            tx.step([torch.ones(2)])
            m = float((params["w"].detach() - before).abs().max())
            if m > 0:
                mags.append(m)
        return mags

    # no accumulation: decay after iteration 4
    ref = fired_magnitudes(1, 8)
    # accumulation 2: the same decay point in iterations (micro-steps)
    acc = fired_magnitudes(2, 8)
    # ref updates every iteration: 8 updates, decayed from the 5th; acc
    # every 2nd micro-step: 4 updates, decayed from the 3rd
    assert len(ref) == 8 and len(acc) == 4
    assert ref[3] / ref[4] == pytest.approx(2.0, rel=1e-5)
    assert acc[1] / acc[2] == pytest.approx(2.0, rel=1e-5)


def test_grad_accum_matches_optax_multisteps():
    """Four micro-steps at k 2 (the clip inactive, then active), with the
    milestones rescaled from iterations: the parameters after each
    micro-step equal optax.MultiSteps'."""
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=5).astype(np.float32)}}
    lrs = {"a": 2e-3, "b": {"c": 5e-4}}
    jtx = j_make_optimizer(lrs, milestones=(2, 5), gamma=0.5, grad_accum=2)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    state = jtx.init(jp)

    @jax.jit
    def jstep(g, state, p):
        up, state = jtx.update(g, state, p)
        return optax.apply_updates(p, up), state

    tp = jax.tree_util.tree_map(torch.from_numpy, init)
    tx = make_optimizer(tp, lrs, milestones=(2, 5), gamma=0.5, grad_accum=2)
    for i, scale in enumerate((0.3, 1e-2, 4.0, 2.0)):
        g = jax.tree_util.tree_map(lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32),
                                   init)
        jp, state = jstep(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        tx.step([torch.from_numpy(x) for x in tree_leaves(g)])
        for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7,
                                       err_msg=f"micro-step {i}")
    assert (tx.count, tx.micro) == (2, 4)


@pytest.mark.parametrize("kind", ["rgb", "sh", "ao_face", "mesh"])
def test_lr_tree_per_cage_and_frozen_match_jax(kind):
    """`lr_tree_from_config` honours config["cages"][name][lr_key] (SH's
    features_rest keeping its 1/20) and sets zero_frozen's paths to 0, as
    JAX's does, on every option's parameter tree."""
    jmodel, tmodel, _ = mesh_pair() if kind == "mesh" else cage_pair(kind)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    jparams = jax.eval_shape(lambda k: j_init_avatar(k, jmodel), jax.random.PRNGKey(0))
    names = [g.name for g in tmodel.garments]
    config = {"lr": 2e-3, "feature_lr": 3e-3,
              "cages": {names[0]: {"feature_lr": 0.04, "deform_mlp_lr": 1e-5},
                        names[1]: {"scaling_lr": 7e-4}}}
    frozen = (("garments", names[1], "color_field"), ("camera_calib",))
    t = lr_tree_from_config(tparams, config, zero_frozen=frozen)
    j = j_lr_tree(jparams, config, zero_frozen=frozen)
    assert jax.tree_util.tree_structure(t) == jax.tree_util.tree_structure(j)
    assert tree_leaves(t) == jax.tree_util.tree_leaves(j)
    g0 = t["garments"][names[0]]
    assert tree_leaves(g0["colors_feat"]) == [0.04]
    assert set(tree_leaves(g0["deformation_field"])) == {1e-5}
    assert set(tree_leaves(t["garments"][names[1]]["color_field"])) == {0.0}
    if kind == "sh":
        assert g0["features_rest"] == pytest.approx(0.04 / 20)
