"""The VGG19 perceptual term (`train/losses.py`) against the JAX package
on the CPU: the random stack's layout and its carrying across, the .npz
loader, the five feature levels, `vgg_loss` with the crop offsets JAX
draws handed to the port, and its gradient; then `render_frame`'s VGG
term against `vgg_loss` of its own images, before and after
enable_vgg_from.

The stack compared is the port's random stack carried to the JAX package
(JAX's own takes ~11 s to draw on the CPU; its layout is read with
`jax.eval_shape`). Tolerances: features, loss and gradient within rel
L2 1e-5 (float32 convolutions summing in another order; both in full
float32, as JAX's Precision.HIGH is on XLA's CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.train import losses as jl
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.model.avatar import init_avatar
from d3ga_tpu_torch.train import losses as tl
from d3ga_tpu_torch.train.step import LossWeights, render_frame
from d3ga_tpu_torch.utils.tree import tree_leaves

REL = 1e-5
CROP = 16  # a small crop, so the crop path runs at test size


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def stacks():
    tvgg = tl.init_vgg19_features(torch.Generator().manual_seed(0), allow_random=True,
                                  device="cpu")
    convs = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tvgg["convs"]))
    return tvgg, {"convs": convs, "pretrained": False}


@pytest.fixture(scope="module")
def jax_vgg_loss():
    """JAX's vgg_loss and its gradient in pred, compiled once (the stack
    an argument, not a constant of the program)."""
    return jax.jit(jax.value_and_grad(
        lambda p, g, key, convs: jl.vgg_loss({"convs": convs}, p, g, crop_key=key,
                                             crop_size=CROP)))


def test_random_stack_layout(stacks):
    tvgg, _ = stacks
    shapes = jax.eval_shape(lambda k: jl.init_vgg19_features(k, allow_random=True)["convs"],
                            jax.random.PRNGKey(0))
    assert [tuple(c["w"].shape) for c in tvgg["convs"]] == [s["w"].shape for s in shapes]
    assert [tuple(c["b"].shape) for c in tvgg["convs"]] == [s["b"].shape for s in shapes]
    assert tl.VGG19_CFG == jl.VGG19_CFG and tl.FEATURE_LAYERS == jl.FEATURE_LAYERS
    assert tvgg["pretrained"] is False
    for c in tvgg["convs"]:  # He-normal weights, zero biases
        fan_in = c["w"].shape[1] * 9
        assert abs(float(c["w"].std()) / np.sqrt(2.0 / fan_in) - 1) < 0.05
        assert not c["b"].any()
    assert tl.init_vgg19_features(device="cpu") is None and jl.init_vgg19_features() is None


def test_carried_across_and_npz(stacks, tmp_path):
    tvgg, _ = stacks
    back = convert.params_from_numpy(convert.params_to_numpy(tvgg), device="cpu")
    assert back["pretrained"] is False
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(back["convs"], tvgg["convs"]))
    rng = np.random.default_rng(3)
    arrays = {f"{k}{i}": rng.normal(size=(2, 3)).astype(np.float32)
              for i in range(16) for k in "wb"}
    path = tmp_path / "vgg.npz"
    np.savez(path, **arrays)
    jv, tv = jl.init_vgg19_features(weights_path=str(path)), tl.init_vgg19_features(
        weights_path=str(path), device="cpu")
    assert jv["pretrained"] and tv["pretrained"] and len(tv["convs"]) == len(jv["convs"]) == 16
    for a, b in zip(tv["convs"], jv["convs"]):
        assert np.array_equal(a["w"].numpy(), np.asarray(b["w"]))
        assert np.array_equal(a["b"].numpy(), np.asarray(b["b"]))


def test_features_match_jax(stacks):
    tvgg, jvgg = stacks
    x = np.random.default_rng(1).uniform(size=(1, 3, 32, 40)).astype(np.float32)
    jf = jax.jit(jl._vgg_forward_features)(jvgg, jnp.asarray(x))
    tf = tl._vgg_forward_features(tvgg, torch.from_numpy(x))
    assert len(tf) == len(jf) == 5
    for t, j in zip(tf, jf):
        assert t.shape == j.shape and rel_l2(t, j) <= REL


@pytest.mark.parametrize("seed", [0, 3])
def test_vgg_loss_and_grad_match_jax(stacks, jax_vgg_loss, seed):
    """With the crop: the x0.5 downsample of 3 x 48 x 68 is 24 x 34, the 16
    crop's offsets drawn as JAX draws them from the crop key."""
    tvgg, jvgg = stacks
    rng = np.random.default_rng(seed)
    pred, gt = (rng.uniform(size=(3, 48, 68)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(seed)
    ky, kx = jax.random.split(key)
    ranges = tl.vgg_crop(pred.shape, CROP)
    assert ranges == (24 - CROP, 34 - CROP)
    crop = (int(jax.random.randint(ky, (), 0, ranges[0] + 1)),
            int(jax.random.randint(kx, (), 0, ranges[1] + 1)))
    jv, jg = jax_vgg_loss(jnp.asarray(pred), jnp.asarray(gt), key, jvgg["convs"])
    tp = torch.from_numpy(pred).requires_grad_(True)
    tv = tl.vgg_loss(tvgg, tp, torch.from_numpy(gt), crop=crop, crop_size=CROP)
    (tg,) = torch.autograd.grad(tv, tp)
    assert rel_l2(tv.detach(), jv) <= REL and rel_l2(tg, jg) <= REL
    assert float(tg.abs().max()) > 0


def test_l2_and_bce_match_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(size=(3, 10, 7)).astype(np.float32) for _ in range(2))
    for tf, jf in ((tl.l2_loss, jl.l2_loss), (tl.bce_loss, jl.bce_loss)):
        np.testing.assert_allclose(float(tf(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(jf(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_render_frame_vgg_term(stacks):
    """render_frame's term is vgg_weight x `vgg_loss` of its own images once
    iteration > enable_vgg_from, and a zero that reads no VGG stack
    before; its gradient reaches the parameters."""
    tvgg, _ = stacks
    model, _, lbs_dim = tsyn.build_synthetic_avatar(n_garments=1, n_gaussians=64, device="cpu")
    params = init_avatar(torch.Generator().manual_seed(0), model)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    rng = np.random.default_rng(5)
    batch = {"lbs": torch.from_numpy((rng.normal(size=lbs_dim) * 0.1).astype(np.float32)),
             "image": torch.from_numpy(rng.uniform(size=(3, 48, 48)).astype(np.float32)),
             "alpha": torch.ones(1, 48, 48), "silhouette": torch.full((3, 48, 48), 0.5),
             "camera": tsyn.orbit_camera(0.4, 48, 48, device="cpu"), "frame_idx": 0,
             "camera_idx": 1}
    lw = LossWeights(enable_vgg_from=1)
    bg = torch.tensor([0.2, 0.4, 0.6])
    terms, aux = render_frame(params, model, batch, bg, max_per_tile=32, vgg_params=tvgg,
                              loss_weights=lw, iteration=2)
    want = tl.vgg_loss(tvgg, aux["pred_image"], aux["gt_image"]) * lw.vgg_weight
    assert float(terms["vgg_loss"].detach()) == pytest.approx(float(want.detach()), rel=1e-6)
    g = torch.autograd.grad(terms["vgg_loss"], leaves, allow_unused=True, materialize_grads=True)
    assert any(float(t.abs().max()) > 0 for t in g)
    before, _ = render_frame(params, model, batch, bg, max_per_tile=32, vgg_params={},
                             loss_weights=lw, iteration=1)
    assert float(before["vgg_loss"]) == 0.0
