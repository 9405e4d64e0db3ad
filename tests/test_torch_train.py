"""The training slice against the JAX package, on the CPU: embedding
lookup, calibration with its 0.1 gradient scale, the losses, the
optimizer, `render_frame` (fused branch) with every parameter leaf's
gradient, and three end-to-end steps, on a small synthetic avatar (2
garments x 150 Gaussians, 64x48 px, K 128, dup 3, depth_exact) with
bench_train.py's raster configuration. The weights are the port's own
initialization from a seed, carried across to the JAX package.

The JAX step runs its Pallas kernels in interpret mode, with the short
traces of tests/test_torch_raster_bwd.py (the combine's 1280-lane window,
16 blend tiles a program in an in-kernel loop); one value-and-grad,
compiled once at XLA's optimization level 0, serves every test. The JAX
optimizer (the package's own optax chain) runs on the parameters raveled
into one vector with a per-element rate vector: the same elementwise
update, one leaf to compile instead of 72.

Camera 2 is not the identity camera, and its calibration row is
perturbed, so the calibration and its 0.1 gradient scale are exercised;
the frame embedding is looked up for frame 1.

Tolerances, each with its reason:
- loss terms rtol 1e-5: float32 sums over the image in another order
  (and the JAX blend's bf16 hi/lo split matmuls, ~2^-17 relative);
- gradients: relative L2 per leaf <= 1e-4 (measured worst 4.6e-6, median
  9e-7). The raster's threshold rules (alpha >= 1/255, T < 1e-4,
  raw < 0.99) can fall differently under the two roundings and move one
  pixel's share of a record's gradient; none does on these inputs;
- the optimizer fed the same gradients: rtol 1e-6 with atol 1e-7. optax
  takes Adam's bias corrections 1 - b^t in float32 (1 - 0.999 is off by
  4.7e-5 relative there), torch.optim.Adam in double, so an update (at
  most the rate, 1e-3, in size) moves by up to ~2.4e-5 of itself;
- three steps: every loss term rtol 1e-4 at each step, the updated
  parameters relative L2 <= 1e-4 per leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu.fields.calibration import apply_camera_calibration as j_calib
from d3ga_tpu.fields.embeddings import embedding_lookup as j_lookup
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu.raster import pallas_segsum as jseg
from d3ga_tpu.train import losses as jlosses
from d3ga_tpu.train.optim import lr_tree_from_config as j_lr_tree
from d3ga_tpu.train.optim import make_optimizer as j_make_optimizer
from d3ga_tpu.train.optim import multistep_schedule as j_schedule
from d3ga_tpu.train.step import LossWeights as JLossWeights
from d3ga_tpu.train.step import render_frame as j_render_frame
from d3ga_tpu.train.step import total_loss as j_total_loss
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.fields.calibration import apply_camera_calibration
from d3ga_tpu_torch.fields.embeddings import embedding_lookup
from d3ga_tpu_torch.model.avatar import init_avatar
from d3ga_tpu_torch.raster import blend_ct, extract, segsum
from d3ga_tpu_torch.train import losses as tlosses
from d3ga_tpu_torch.train.optim import lr_tree_from_config, make_optimizer, multistep_schedule
from d3ga_tpu_torch.train.step import LossWeights, make_train_step, render_frame
from d3ga_tpu_torch.utils.tree import tree_leaves
from torch_parity import jit_o0, port_model

W, H, K = 64, 48, 128
CONFIG = {"raster_backend": "pallas_blend", "raster_opts": {"coarse": "dupsort_depth", "dup": 3}}
FRAME_IDX, CAMERA_IDX = 1, 2
TERM_RTOL, GRAD_REL = 1e-5, 1e-4


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setattr(jseg, "W", 1280)
    mp.setattr(jbct, "G_CT", 16)
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(
        n_garments=2, n_gaussians=150, config_overrides=CONFIG
    )
    tmodel = port_model(jmodel, 2, config_overrides=CONFIG)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    rng = np.random.default_rng(5)
    corr = tparams["camera_calib"]["corrections"]
    corr += torch.from_numpy(rng.normal(0, 0.05, tuple(corr.shape)).astype(np.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tparams))
    data = {
        "lbs": (rng.normal(size=lbs_dim) * 0.1).astype(np.float32),
        "image": rng.uniform(size=(3, H, W)).astype(np.float32),
        "alpha": (rng.uniform(size=(1, H, W)) > 0.3).astype(np.float32),
        "silhouette": np.full((3, H, W), 0.5, np.float32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jbatch.update(camera=jsyn.orbit_camera(0.3, W, H), frame_idx=jnp.int32(FRAME_IDX),
                  camera_idx=jnp.int32(CAMERA_IDX))
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    tbatch.update(camera=tsyn.orbit_camera(0.3, W, H, device="cpu"), frame_idx=FRAME_IDX,
                  camera_idx=CAMERA_IDX)

    def jloss(params, rng, iteration):
        terms, _ = j_render_frame(
            params, jmodel, jbatch, rng, max_per_tile=K,
            loss_weights=JLossWeights(enable_vgg_from=0), iteration=iteration,
        )
        return j_total_loss(terms), terms

    jvg = jit_o0(jax.value_and_grad(jloss, has_aux=True), jparams, jax.random.PRNGKey(0), 0)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    rates = jax.tree_util.tree_leaves(j_lr_tree(jparams, {}))
    rate_vec = np.concatenate([np.full(x.size, r, np.float32) for x, r in zip(leaves, rates)])
    jtx = j_make_optimizer(jnp.asarray(rate_vec), milestones=(1, 2))

    def ravel(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        return np.concatenate([np.asarray(x, np.float32).ravel() for x in leaves])

    def unravel(v):
        ends = np.cumsum([x.size for x in leaves])
        parts = np.split(np.asarray(v), ends[:-1])
        return treedef.unflatten([jnp.asarray(a.reshape(x.shape)) for a, x in zip(parts, leaves)])

    @jax.jit
    def jopt(grads, state, params):
        updates, state = jtx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    yield dict(jmodel=jmodel, jparams=jparams, tmodel=tmodel, tparams=tparams,
               jbatch=jbatch, tbatch=tbatch, jvg=jvg, jinit=jtx.init, jopt=jopt,
               ravel=ravel, unravel=unravel)
    mp.undo()


def fresh(tparams):
    return convert.params_from_numpy(convert.params_to_numpy(tparams), device="cpu")


def port_step(pair, plain=False):
    tp = fresh(pair["tparams"])
    tx = make_optimizer(tp, lr_tree_from_config(tp), milestones=(1, 2))
    step = make_train_step(pair["tmodel"], tx, max_per_tile=K,
                           loss_weights=LossWeights(enable_vgg_from=0), plain=plain)
    return tp, tx, step


def jax_bg(key):
    return np.asarray(jax.random.uniform(key, (3,)))


def test_render_frame_matches_jax(pair):
    key = jax.random.PRNGKey(7)
    (_, jterms), jgrads = pair["jvg"](pair["jparams"], key, 0)
    tp, tx, step = port_step(pair)
    before = (extract.launches, blend_ct.launches, blend_ct.bwd_launches, segsum.launches)
    _, terms, aux, grads = step.loss_and_grads(tp, pair["tbatch"], torch.from_numpy(jax_bg(key)), 0)
    assert before == (extract.launches, blend_ct.launches, blend_ct.bwd_launches, segsum.launches)
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=TERM_RTOL, err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == len(tree_leaves(tp))
    for i, (t, j) in enumerate(zip(grads, jleaves)):
        assert t.shape == j.shape
        assert rel_l2(t, j) <= GRAD_REL, (i, t.shape, rel_l2(t, j))
    calib = np.asarray(jgrads["camera_calib"]["corrections"])
    assert np.abs(calib[CAMERA_IDX]).max() > 0 and np.all(np.delete(calib, CAMERA_IDX, 0) == 0)
    frames = np.asarray(jgrads["frame_embeddings"]["table"])
    assert np.abs(frames[FRAME_IDX]).max() > 0 and np.all(np.delete(frames, FRAME_IDX, 0) == 0)
    assert aux["pred_image"].shape == (3, H, W)


def test_optimizer_matches_optax(pair):
    """Clip (inactive, then active), Adam, per-leaf LR, decay at steps 1
    and 2, all fed the same gradients."""
    jparams = pair["jparams"]
    jlr = j_lr_tree(jparams, {})
    tp = fresh(pair["tparams"])
    tlr = lr_tree_from_config(tp)
    assert tree_leaves(tlr) == jax.tree_util.tree_leaves(jlr)
    override = {"feature_lr": 0.1, "lr": 2e-3}
    assert tree_leaves(lr_tree_from_config(tp, override)) == jax.tree_util.tree_leaves(
        j_lr_tree(jparams, override)
    )
    ravel, unravel = pair["ravel"], pair["unravel"]
    jp = jnp.asarray(ravel(jparams))
    state = pair["jinit"](jp)
    tx = make_optimizer(tp, tlr, milestones=(1, 2))
    rng = np.random.default_rng(9)
    for i, scale in enumerate((1e-4, 1.0, 3e-3)):
        g_np = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32), jparams
        )
        assert tx.lr_scale() == pytest.approx(float(j_schedule(1.0, (1, 2), 0.33)(i)))
        jp, state = pair["jopt"](jnp.asarray(ravel(g_np)), state, jp)
        tx.step(tree_leaves(convert.params_from_numpy(g_np, device="cpu")))
        for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(unravel(jp))):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    assert [multistep_schedule(1.0, (1, 2), 0.33)(i) for i in range(3)] == pytest.approx(
        [1.0, 0.33, 0.33**2]
    )


def test_three_steps_match_jax(pair):
    ravel, unravel = pair["ravel"], pair["unravel"]
    jp = pair["jparams"]
    state = pair["jinit"](jnp.asarray(ravel(jp)))
    tp, tx, step = port_step(pair)
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(11), i)
        (_, jterms), jgrads = pair["jvg"](jp, key, i)
        flat, state = pair["jopt"](jnp.asarray(ravel(jgrads)), state, jnp.asarray(ravel(jp)))
        jp = unravel(flat)
        bg = torch.from_numpy(jax_bg(key))
        _, terms, _, grads = step.loss_and_grads(tp, pair["tbatch"], bg, i)
        tx.step(grads)
        for k, v in jterms.items():
            np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=1e-4,
                                       err_msg=f"{k} step {i}")
    for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert rel_l2(t.detach(), j) <= GRAD_REL


def test_step_draws_bg_and_updates(pair):
    """The whole step from a generator: finite metrics, changed
    parameters, the plain raster flag taking the same route on the CPU."""
    tp, tx, step = port_step(pair)
    before = [t.detach().clone() for t in tree_leaves(tp)]
    _, m = step(tp, pair["tbatch"], torch.Generator().manual_seed(3), 0)
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    assert float(m["total_loss"]) == pytest.approx(
        sum(float(m[k]) for k in ("color_loss", "sil_loss", "codes_reg", "scale_loss", "fme_loss")),
        rel=1e-6,
    )
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))
    assert tx.count == 1


def test_unported_options_raise(pair):
    """What still waits raises, naming its ROADMAP item; the capture
    configs' options are ported (tests/test_torch_train_capture.py): a
    VGG stack before enable_vgg_from adds a zero term without reading the
    stack, and the noise target asks for its draw."""
    tm, tp, tb = pair["tmodel"], pair["tparams"], pair["tbatch"]
    bg = torch.zeros(3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_frame(tp, tm, tb, bg, detach_silhouette=("position",))
    terms, _ = render_frame(tp, tm, tb, bg, vgg_params={})
    assert float(terms["vgg_loss"]) == 0.0
    with pytest.raises(ValueError, match="noise"):
        render_frame(tp, tm._replace(config=dict(tm.config, use_random_bg=True)), tb, bg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_frame(tp, tm, tb, bg, band_ctx=("x", 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(tp, lr_tree_from_config(tp), grad_accum=2)


def test_embedding_lookup_and_calibration_grad():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(4, 8)).astype(np.float32)
    table[2] *= 10.0  # norm above max_norm = 8: renormalized
    for idx in (-1, 2, 7):  # clamped into the table
        np.testing.assert_allclose(
            embedding_lookup({"table": torch.from_numpy(table)}, idx).numpy(),
            np.asarray(j_lookup({"table": jnp.asarray(table)}, idx)), rtol=1e-6, atol=1e-7,
        )
    corr = (np.tile([1.0, 1, 1, 0, 0, 0], (3, 1)) + rng.normal(0, 0.1, (3, 6))).astype(np.float32)
    rgb = rng.uniform(size=(20, 3)).astype(np.float32)
    for cam in (0, 1):
        jg = jax.grad(lambda p, x: jnp.sum(j_calib({"corrections": p}, x, cam) ** 2), (0, 1))(
            jnp.asarray(corr), jnp.asarray(rgb)
        )
        p = torch.from_numpy(corr).requires_grad_(True)
        x = torch.from_numpy(rgb).requires_grad_(True)
        y = apply_camera_calibration({"corrections": p}, x, cam, training=True)
        tg = torch.autograd.grad(torch.sum(y**2), (p, x), materialize_grads=True)
        for t, j in zip(tg, jg):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(size=(3, 40, 36)).astype(np.float32) for _ in range(2))
    m = (rng.uniform(size=(1, 40, 36)) > 0.2).astype(np.float32) if masked else None
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tm = None if m is None else torch.from_numpy(m)
    pairs = [(tlosses.l1_loss(ta, tb), jlosses.l1_loss(a, b)),
             (tlosses.masked_psnr(ta, tb, tm), jlosses.masked_psnr(a, b, m))]
    if masked:
        pairs.append((tlosses.masked_ssim(ta, tb, tm), jlosses.masked_ssim(a, b, m)))
    else:
        pairs += [(tlosses.ssim(ta, tb), jlosses.ssim(a, b)),
                  (tlosses.psnr(ta, tb), jlosses.psnr(a, b))]
    for t, j in pairs:
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
    np.testing.assert_allclose(tlosses.ssim_map(ta, tb).numpy(), np.asarray(jlosses.ssim_map(a, b)),
                               rtol=0, atol=1e-5)
