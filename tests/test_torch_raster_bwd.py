"""Parity of the port's raster backward with the JAX package, on the CPU:
the plain versions of K3 (blend backward, `blend_gather_ct_bwd_plain`)
and K4 (the per-Gaussian combine, `segsum.combine_from_slots`), and the
gradient of the gather + blend through the `torch.autograd.Function`
that CPU and CUDA tensors share, against the JAX package's Pallas
kernels in interpret mode.

Two module-scoped monkeypatches keep the JAX side's interpret-mode
traces short (the whole test suite runs near its time limit), each a
configuration the JAX package itself runs and tests:
- `pallas_segsum.W` = 1280 lanes (16384 by default): the same combine
  kernel and sums, the window still covering B * dup^2 = 128 * 9 ids, a
  13x shorter trace (12 s to compile at the default width);
- `pallas_blend_ct.G_CT` = 16 tiles a program (8 by default): the blend
  kernels iterate their tiles with an in-kernel loop, traced once,
  instead of the static 8-way unroll (tests/test_pallas_blend.py covers
  that path); the per-tile math is the same, the compile half as long.
  With it, `_bgs_bwd` (the raster VJP test) takes its `ct` branch: K3
  writes [T, CR, K] and the combine reads layout "ct". The default
  G_CT = 8 takes the `ct_rows` branch (rows_out K3, layout "ct_rows");
  the combine test runs that layout directly, on the port's drec;
and each JAX computation is compiled at XLA's optimization level 0
(`torch_parity.jit_o0`).

Tolerances: the JAX kernels contract in bf16 hi/lo split matmuls, good
to about 2^-17 (7.6e-6) relative per sum, over sums of up to 256 terms
weighted by the pixel basis (dx^2 up to 225); the port sums in float32.
Cotangents are held to 1e-5 of the largest value (about 20 ulps of the
JAX side's rounding at that scale), the per-Gaussian sums to rtol 1e-4
with atol 1e-5 of the largest, as the JAX package's own segsum tests do.
Where pixels sit at a threshold (raw at the 0.99 clamp, T at the 1e-4
stop), the two roundings can decide it differently and move a record's
cotangent by a whole pixel's share: there the p999 error and the share
of elements off by more than 1e-3 of the largest are held instead
(PALLAS_PARITY.json's columns), as the forward's image tests do.

The CUDA kernels run only on the card: the tests marked `cuda` hold them
against their plain versions and skip without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.raster import pallas_segsum as jseg
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu_torch.raster import blend_ct, segsum
from d3ga_tpu_torch.raster import tiles as ttiles
from d3ga_tpu.raster.project import project_gaussians as j_project
from d3ga_tpu_torch.raster.project import project_gaussians as t_project
from test_torch_raster import blend_inputs, cameras, random_scene
from torch_parity import jit_o0

W, H, K, C, DUP = 64, 48, 128, 6, 3
DUP2 = DUP * DUP
REL = 1e-5  # cotangents: atol as a share of the largest |value|


def rel_close(a, b, rel=REL, rtol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rel * float(np.abs(b).max()))


def flip_close(a, b, rel=REL, flip_at=1e-3, flip_max=1e-3):
    """p999 |a - b| within rel of b's scale; at most a flip_max share of
    elements off by more than flip_at of it (threshold flips)."""
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    scale = float(np.abs(b).max())
    assert np.quantile(err, 0.999) <= rel * scale
    assert np.mean(err > flip_at * scale) <= flip_max


@pytest.fixture(scope="module", autouse=True)
def short_traces():
    mp = pytest.MonkeyPatch()
    mp.setattr(jseg, "W", 1280)
    mp.setattr(jbct, "G_CT", 16)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def selection():
    """A real dupsort_depth selection of a 64x48 frame (300 Gaussians,
    dup 3, K 128, some fully opaque), and a cotangent image."""
    means, cov6, opac, colors = random_scene(3, 300, W, H)
    opac[::7] = 1.0
    _, tcam = cameras(W, H)
    b = ttiles.bin_gaussians(
        torch.from_numpy(means), tcam, torch.from_numpy(cov6), torch.from_numpy(opac),
        torch.from_numpy(colors), K, DUP, plain=True,
    )
    cnt = torch.clamp(b.counts, max=K).contiguous()
    g = np.random.default_rng(0).normal(size=(C + 1, b.nty * 16, b.ntx * 16)).astype(np.float32)
    return b, cnt, torch.from_numpy(g)


def clamp_inputs():
    """blend_inputs with a quarter of the records fully opaque and wide
    (sigma 20 px), so raw >= 0.99 within ~2.8 px of their centres: the
    clamp's zero gradient and many early terminations are exercised."""
    records_ext, idx, counts = blend_inputs(7, 4, 3, K, n=300)
    records_ext[:-1:4, 2:5] = (1 / 400, 0.0, 1 / 400)
    records_ext[:-1:4, 5] = 1.0
    return records_ext, idx, counts


def test_bwd_plain_matches_pallas_kernel():
    records_ext, idx, counts = clamp_inputs()
    ntx, nty = 4, 3
    g = np.random.default_rng(1).normal(size=(C + 1, nty * 16, ntx * 16)).astype(np.float32)
    rec_ct = jnp.swapaxes(jnp.asarray(records_ext)[jnp.asarray(idx)], 1, 2)
    args = (rec_ct, jnp.asarray(counts), jnp.asarray(g))
    j = jit_o0(lambda r, c, gg: jbct._run_backward_ct(r, c, gg, ntx, nty, C, interpret=True),
               *args)(*args)
    t = blend_ct.blend_gather_ct_bwd_plain(
        *map(torch.from_numpy, (records_ext, idx, counts, g)), ntx, nty, C, tile_chunk=5
    )
    assert t.shape == (ntx * nty, K, 6 + C)
    flip_close(t.numpy(), np.swapaxes(np.asarray(j), 1, 2))
    # slots past each tile's count carry no cotangent
    dead = np.arange(K)[None] >= counts[:, None]
    assert np.all(t.numpy()[dead] == 0.0)
    # the clamp is exercised: live opaque records centred inside their tile
    tiles = np.arange(ntx * nty)
    x = records_ext[idx, 0] - (tiles % ntx * 16)[:, None]
    y = records_ext[idx, 1] - (tiles // ntx * 16)[:, None]
    inside = (x >= 0) & (x < 16) & (y >= 0) & (y < 16)
    assert np.any(~dead & inside & (records_ext[idx, 5] == 1.0))


def test_combine_from_slots_matches_jax(selection):
    check_combine_from_slots(selection, "rec")


def test_combine_from_slots_ct_rows_matches_jax(selection):
    check_combine_from_slots(selection, "ct_rows")


def check_combine_from_slots(selection, layout):
    """layout "rec" takes the port's drec [T, K, CR] as it is; "ct_rows"
    (the default training path's rows_out layout) the same cotangents as
    [nty, CR, ntx * K], whose columns are in the same slot order."""
    b, cnt, g = selection
    n = b.records_ext.shape[0] - 1
    drec = blend_ct.blend_gather_ct_bwd_plain(b.records_ext, b.idx, cnt, g, b.ntx, b.nty, C)
    t = segsum.combine_from_slots(drec, b.idx, n, DUP2, plain=True)
    jd = drec.numpy()
    if layout == "ct_rows":
        jd = jd.reshape(b.nty, b.ntx, K, 6 + C).transpose(0, 3, 1, 2).reshape(b.nty, 6 + C, -1)
    args = (jnp.asarray(jd), jnp.asarray(b.idx.numpy()))
    j = jit_o0(
        lambda d, i: jseg.combine_from_slots(d, i, n, DUP2, interpret=True, layout=layout), *args
    )(*args)
    assert t.shape == (n + 1, 6 + C)
    rel_close(t.numpy(), np.asarray(j), rtol=1e-4)
    # against float64 sums: only the summation order differs
    ref = np.zeros((n + 1, 6 + C))
    np.add.at(ref, b.idx.numpy().reshape(-1), drec.numpy().reshape(-1, 6 + C).astype(np.float64))
    ref[n] = 0.0
    rel_close(t.numpy(), ref, rel=1e-6, rtol=1e-6)


def test_raster_vjp_matches_jax(selection):
    """The gradient wrt the packed records through the autograd.Function
    (CPU route: plain K2, K3, sort, K4) against jax.vjp of the JAX
    package's blend_gather_segsum_ct (K2, K3 and the segsum combine)."""
    b, cnt, g = selection
    def fwd_bwd(r, i, c, gg):
        out, vjp = jax.vjp(
            lambda rr: jseg.blend_gather_segsum_ct(rr, i, c, b.ntx, b.nty, C, DUP2, True), r
        )
        return out, vjp(gg)[0]

    args = tuple(jnp.asarray(t.numpy()) for t in (b.records_ext, b.idx, cnt, g))
    j_out, j_grad = jit_o0(fwd_bwd, *args)(*args)
    rec = b.records_ext.clone().requires_grad_(True)
    before = (blend_ct.launches, blend_ct.bwd_launches, segsum.launches)
    out = blend_ct.blend_gather_ct(rec, b.idx, cnt, b.ntx, b.nty, C, dup2=DUP2)
    assert type(out.grad_fn).__name__ == "_BlendGatherCTBackward"
    out.backward(g)
    assert (blend_ct.launches, blend_ct.bwd_launches, segsum.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=1e-4)
    rel_close(rec.grad.numpy(), np.asarray(j_grad), rtol=1e-4)
    # the Function's backward is exactly the plain K3 + combine
    drec = blend_ct.blend_gather_ct_bwd_plain(b.records_ext, b.idx, cnt, g, b.ntx, b.nty, C)
    n = b.records_ext.shape[0] - 1
    assert torch.equal(rec.grad, segsum.combine_from_slots(drec, b.idx, n, DUP2, plain=True))


def test_rasterize_tiled_is_differentiable(selection):
    """Gradients reach means, covariances, opacities and colours, on the
    plain route whatever the flag (CPU tensors)."""
    means, cov6, opac, colors = (
        torch.from_numpy(a).requires_grad_(True) for a in random_scene(3, 300, W, H)
    )
    _, tcam = cameras(W, H)
    img, aux = ttiles.rasterize_tiled(
        means, tcam, torch.ones(6), cov3d=cov6, opacities=opac, colors=colors, max_per_tile=K,
        use_pallas=True, coarse="dupsort_depth", dup=DUP,
    )
    img.square().sum().backward()
    for t in (means, cov6, opac, colors):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0.0
    assert int(aux.n_contrib) > 0


def test_project_gradients_match_jax():
    """Autograd of the projection against JAX AD where the frameworks
    could split gradients differently: Gaussians exactly at the fov clamp
    (jnp.clip gives half the gradient at a tie, torch.clamp all of it),
    and one with a negative-definite covariance, whose radius is NaN
    under the square roots' maxima (no gradient flows back through the
    integer radius in either framework)."""
    means, cov6, opac, colors = random_scene(2, 64, W, H)
    jcam, tcam = cameras(W, H)
    limx = np.float32(np.float32(1.3) * np.asarray(tcam.tanfovx))
    means[:4, 2] = 2.0
    means[:2, 0] = 2.0 * limx  # x / z == 1.3 tan(fov_x / 2) exactly
    means[2:4, 0] = -2.0 * limx
    cov6[4] = -100.0 * cov6[4]  # both screen eigenvalues < 0: a NaN radius
    w_xy, w_conic = (np.random.default_rng(3).normal(size=(64, k)).astype(np.float32)
                     for k in (2, 3))

    def j_loss(m, c, o):
        p = j_project(m, jcam, cov3d=c, opacities=o, colors=jnp.asarray(colors))
        return (jnp.sum(p.xy * w_xy) + jnp.sum(p.conic * w_conic) + jnp.sum(p.opacity)
                + jnp.sum(p.depth))

    jg = jax.grad(j_loss, (0, 1, 2))(*map(jnp.asarray, (means, cov6, opac)))
    tm, tc, to = (torch.from_numpy(a).requires_grad_(True) for a in (means, cov6, opac))
    p = t_project(tm, tcam, cov3d=tc, opacities=to, colors=torch.from_numpy(colors))
    loss = ((p.xy * torch.from_numpy(w_xy)).sum() + (p.conic * torch.from_numpy(w_conic)).sum()
            + p.opacity.sum() + p.depth.sum())
    loss.backward()
    assert np.all(means[:2, 0] / means[:2, 2] == limx)
    assert not bool(p.valid[4]) and int(p.radius[4]) == 0
    for t, j in zip((tm, tc, to), jg):
        assert bool(torch.isfinite(t.grad).all())
        # float32 rounding of terms up to 1e4 (1 / det of small footprints)
        rel_close(t.grad.numpy(), np.asarray(j), rel=1e-6, rtol=1e-5)


class TestCombineSorted:
    def test_plain_matches_float64_sums(self):
        rng = np.random.default_rng(2)
        n, m = 200, 1500
        ids = np.sort(np.minimum(rng.integers(0, n + 40, m), n + 3)).astype(np.int32)
        keep = np.ones(m, bool)
        for i in range(n):  # at most dup2 occurrences of an id
            keep[np.flatnonzero(ids == i)[DUP2:]] = False
        ids = ids[keep]
        g = rng.normal(size=(12, ids.size)).astype(np.float32)
        out = segsum.combine_sorted(torch.from_numpy(ids), torch.from_numpy(g), n, DUP2)
        ref = np.zeros((n + 4, 12))
        np.add.at(ref, ids, g.T.astype(np.float64))
        np.testing.assert_allclose(out.numpy(), ref[:n], rtol=1e-6, atol=1e-6)

    def test_perm_reads_columns_in_place(self):
        """Reading the columns through the sort's permutation gives the
        sums of the gathered columns, bit for bit."""
        rng = np.random.default_rng(5)
        n = 300
        idx = torch.from_numpy(np.minimum(rng.integers(0, n + 60, 900), n).astype(np.int32))
        g = torch.from_numpy(rng.normal(size=(12, 900)).astype(np.float32))
        ids_sorted, perm = torch.sort(idx, stable=True)
        ref = segsum.combine_sorted(ids_sorted, g[:, perm].contiguous(), n, DUP2)
        out = segsum.combine_sorted(ids_sorted, g, n, DUP2, perm=perm.to(torch.int32))
        assert torch.equal(out, ref)

    @pytest.mark.parametrize("perm_dtype", [torch.int32, torch.int64])
    def test_perm_and_rows_match_jax(self, perm_dtype):
        """The slot rows read through the sort's permutation (int64, as
        torch.sort returns it, or int32) into n + 1 rows, the last zero,
        against the Pallas kernel on the gathered columns."""
        rng = np.random.default_rng(6)
        n = 400
        idx = np.minimum(rng.integers(0, n + 80, 1500), n).astype(np.int32)
        for i in range(n):  # at most dup2 slots a Gaussian
            idx[np.flatnonzero(idx == i)[DUP2:]] = n
        rows = rng.normal(size=(idx.size, 12)).astype(np.float32)
        ids_sorted, perm = torch.sort(torch.from_numpy(idx), stable=True)
        g = torch.from_numpy(rows).T  # slot order, as combine_from_slots reads it
        out = segsum.combine_sorted(ids_sorted, g, n, DUP2, perm.to(perm_dtype), rows=n + 1)
        args = (jnp.asarray(ids_sorted.numpy()), jnp.asarray(rows[perm.numpy()].T))
        j = jit_o0(lambda i, gs: jseg.combine_sorted(i, gs, n, DUP2, interpret=True), *args)(*args)
        assert out.shape == (n + 1, 12)
        assert float(out[n].abs().max()) == 0.0
        rel_close(out[:n].numpy(), np.asarray(j), rtol=1e-4)
        # the same sums, bit for bit, whatever the permutation's dtype or the rows
        assert torch.equal(out[:n], segsum.combine_sorted(ids_sorted, g, n, DUP2, perm.int()))

    def test_plain_on_edge_inputs(self):
        """K4's edge inputs (chip_smoke.k4_edge_cases: n not a multiple of
        32, empty runs at the start, middle and end, runs of exactly 9,
        only sentinels, m < 32, n = 0, runs over 32-id chunks, the row and
        column layouts, CR 9) against float64 sums; the rows past n zero;
        int32 and int64 permutations bit-equal."""
        from chip_smoke import k4_edge_cases

        for name, ids, g, n, perm, dup2 in k4_edge_cases(torch.device("cpu")):
            out = segsum.combine_sorted(ids, g, n, dup2, perm, rows=n + 1)
            cols = g if perm is None else g[:, perm]
            ref = np.zeros((n + 1, g.shape[0]))
            live = ids.numpy() < n
            np.add.at(ref, ids.numpy()[live], cols.numpy().T[live].astype(np.float64))
            assert out.shape == ref.shape, name
            rel_close(out.numpy(), ref, rel=1e-6, rtol=1e-6)
            assert float(out[n].abs().max()) == 0.0, name
            if perm is not None:
                assert torch.equal(out, segsum.combine_sorted(ids, g, n, dup2, perm.int(), n + 1))
            assert torch.equal(out[:n], segsum.combine_sorted(ids, g, n, dup2, perm)), name

    def test_baseline_needs_the_card(self):
        ids = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            segsum.combine_sorted_baseline(ids, torch.ones(12, 4), 2)

    def test_checks_the_occurrence_bound(self):
        ids = torch.tensor([0, 1, 1, 1, 5], dtype=torch.int32)
        g = torch.ones(12, 5)
        with pytest.raises(ValueError, match="dup2"):
            segsum.combine_sorted_plain(ids, g, 5, dup2=2)
        out = segsum.combine_sorted_plain(ids, g, 5, dup2=3)
        assert out[:, 0].tolist() == [1.0, 3.0, 0.0, 0.0, 0.0]  # the sentinel 5 dropped

    def test_wrappers_raise_off_cpu_and_cuda(self):
        meta = torch.empty(10, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="device"):
            segsum.combine_sorted(meta, torch.empty(12, 10, device="meta"), 4)
        with pytest.raises(ValueError, match="device"):
            blend_ct.blend_gather_ct_bwd(
                torch.empty(5, 12, device="meta"), meta.reshape(1, 10), meta[:1],
                torch.empty(7, 16, 16, device="meta"), 1, 1, 6,
            )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    def test_bwd_kernel_matches_plain(self, cuda_device):
        records_ext, idx, counts = clamp_inputs()
        g = np.random.default_rng(1).normal(size=(C + 1, 48, 64)).astype(np.float32)
        args = [torch.from_numpy(a).to(cuda_device) for a in (records_ext, idx, counts, g)]
        ref = blend_ct.blend_gather_ct_bwd_plain(*args, 4, 3, C)
        out = blend_ct.blend_gather_ct_bwd(*args, 4, 3, C)
        torch.cuda.synchronize()
        flip_close(out.cpu().numpy(), ref.cpu().numpy())

    def test_combine_kernel_matches_plain(self, cuda_device):
        rng = np.random.default_rng(4)
        ids = np.sort(np.repeat(np.arange(5000), rng.integers(0, DUP2 + 1, 5000)))
        ids = np.concatenate([ids, np.full(300, 5000)]).astype(np.int32)
        g = torch.from_numpy(rng.normal(size=(12, ids.size)).astype(np.float32))
        ref = segsum.combine_sorted_plain(torch.from_numpy(ids), g, 5000, DUP2)
        out = segsum.combine_sorted(torch.from_numpy(ids).to(cuda_device), g.to(cuda_device), 5000)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref)
        # slot rows read through a permutation, as combine_from_slots does
        perm = torch.from_numpy(rng.permutation(ids.size).astype(np.int32))
        rows = torch.empty(ids.size, 12)
        rows[perm.long()] = g.T
        out = segsum.combine_sorted(torch.from_numpy(ids).to(cuda_device), rows.T.to(cuda_device),
                                    5000, perm=perm.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref)

    def test_combine_kernel_edges(self, cuda_device):
        """K4's edge inputs: the kernel bit-equal to its plain version with
        int32 and int64 permutations into n and n + 1 rows, and to the
        baseline design on the first n rows."""
        from chip_smoke import k4_edge_cases

        for name, ids, g, n, perm, dup2 in k4_edge_cases(cuda_device):
            for p in ([None] if perm is None else [perm, perm.int()]):
                for rows in (n, n + 1):
                    out = segsum.combine_sorted(ids, g, n, perm=p, rows=rows)
                    ref = segsum.combine_sorted_plain(ids, g, n, dup2, p, rows=rows)
                    torch.cuda.synchronize()
                    assert torch.equal(out, ref), (name, rows)
                if n:
                    base = segsum.combine_sorted_baseline(ids, g, n, None if p is None else p.int())
                    assert torch.equal(out[:n], base), name
