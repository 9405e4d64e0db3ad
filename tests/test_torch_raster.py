"""Parity of the PyTorch port's rasterizer pieces with the JAX package, on
the CPU: projection, the dupsort_depth selection, and the plain versions
of the two kernels (K1 front-K extraction, K2 gather + blend forward)
against the JAX package's Pallas kernels run in interpret mode.

Integer outputs (selection indices, counts, counters) must be exactly
equal. Blended images: atol 1e-4, because the JAX kernel's bf16 hi/lo
split matmuls are good to about 2^-17 relative and it composites in the
log domain, the port in a plain float32 cumsum.

The JAX blend runs 16 tiles a program (`pallas_blend_ct.G_CT`, 8 by
default): the kernel iterates its tiles in an in-kernel loop traced once
instead of an 8-way static unroll, the same per-tile math with half the
interpret-mode compile (tests/test_pallas_blend.py covers that path).

The CUDA kernels themselves run only on the card: the tests marked
`cuda` hold them against their plain versions and skip without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.raster.tiles as jtiles
from d3ga_tpu.raster.camera import focal2fov as j_focal2fov
from d3ga_tpu.raster.camera import make_camera as j_make_camera
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu.raster.pallas_extract import extract_slices as j_extract_slices
from d3ga_tpu.raster.project import project_gaussians as j_project
from d3ga_tpu_torch.raster import blend_ct, extract
from d3ga_tpu_torch.raster import tiles as ttiles
from d3ga_tpu_torch.raster.camera import make_camera as t_make_camera
from d3ga_tpu_torch.raster.project import project_gaussians as t_project
from d3ga_tpu_torch.raster.project import tile_rect as t_tile_rect

IMG_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tile_loop():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbct, "G_CT", 16)
    yield
    mp.undo()


def random_scene(seed, n, w, h, c=6):
    """Gaussians in front of an identity camera at z in [2, 6]: means,
    packed 3D covariances, opacities [n, 1], colours [n, c] (numpy)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, n)
    f = float(max(w, h))
    x = (rng.uniform(-0.1, 1.1, n) * w - 0.5 * w) * z / f
    y = (rng.uniform(-0.1, 1.1, n) * h - 0.5 * h) * z / f
    means = np.stack([x, y, z], -1).astype(np.float32)
    L = rng.normal(size=(n, 3, 3)) * rng.uniform(0.005, 0.06, (n, 1, 1))
    cov = L @ np.swapaxes(L, -1, -2) + 1e-5 * np.eye(3)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)
    opac = rng.uniform(0.3, 0.99, (n, 1)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, c)).astype(np.float32)
    return means, cov6, opac, colors


def cameras(w, h):
    args = (np.eye(3), np.zeros(3), j_focal2fov(max(w, h), w), j_focal2fov(max(w, h), h), w, h)
    return j_make_camera(*args), t_make_camera(*args, device="cpu")


def test_project_gaussians():
    means, cov6, opac, colors = random_scene(1, 400, 64, 48)
    means[:5, 2] = -1.0  # culled behind the camera
    jcam, tcam = cameras(64, 48)
    j = jax.jit(lambda m, c, o, col: j_project(m, jcam, cov3d=c, opacities=o, colors=col))(
        *map(jnp.asarray, (means, cov6, opac, colors))
    )
    t = t_project(torch.from_numpy(means), tcam, cov3d=torch.from_numpy(cov6),
                  opacities=torch.from_numpy(opac), colors=torch.from_numpy(colors))
    for f in ("xy", "depth", "conic", "color", "opacity"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-5, atol=1e-5)
    assert np.array_equal(t.radius.numpy(), np.asarray(j.radius))
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))
    jr = jtiles.tile_rect(j.xy, j.radius, 16, 4, 3)
    tr = t_tile_rect(t.xy, t.radius, 16, 4, 3)
    for a, b in zip(tr, jr):
        assert np.array_equal(a.numpy(), np.asarray(b))


def selection_inputs(seed, n, ntx, nty, max_span=5):
    """Random tile rects (some wider than the dup window, some empty or
    invalid) and positive depths with exact duplicates and same-quantum
    near-duplicates."""
    rng = np.random.default_rng(seed)
    xmin = rng.integers(0, ntx, n)
    ymin = rng.integers(0, nty, n)
    hot = n // 3  # a hotspot that overfills the cap of a few tiles
    xmin[:hot] = rng.integers(0, 2, hot)
    ymin[:hot] = rng.integers(0, 2, hot)
    xmax = np.minimum(xmin + rng.integers(0, max_span, n), ntx)
    ymax = np.minimum(ymin + rng.integers(1, max_span, n), nty)
    valid = rng.uniform(size=n) > 0.05
    depth = rng.uniform(1.0, 9.0, n).astype(np.float32)
    depth[1::7] = depth[0]
    depth[2::11] = depth[3] * np.float32(1.0 + 2e-7)
    rects = [a.astype(np.int32) for a in (xmin, xmax, ymin, ymax)]
    return rects, valid, depth


def run_selection(rects, valid, depth, ntx, nty, K, dup, depth_exact):
    j = jtiles._select_per_tile_depthkey(
        tuple(jnp.asarray(r) for r in rects), jnp.asarray(valid), jnp.asarray(depth),
        ntx, nty, K, dup=dup, depth_exact=depth_exact,
    )
    t = ttiles._select_per_tile_depthkey(
        tuple(torch.from_numpy(r) for r in rects), torch.from_numpy(valid),
        torch.from_numpy(depth), ntx, nty, K, dup=dup, depth_exact=depth_exact,
    )
    return t, j


class TestSelection:
    @pytest.mark.parametrize("K", [128, 256])
    @pytest.mark.parametrize("depth_exact", [True, False])
    def test_depthkey_exact(self, K, depth_exact):
        """pack_exact keys (depth_exact) and index tie-breaks: idx,
        counts, clamp drops and ties bit-identical; the JAX side cuts the
        windows with its Pallas extraction kernel in interpret mode."""
        rects, valid, depth = selection_inputs(K + depth_exact, 3000, 12, 9)
        t, j = run_selection(rects, valid, depth, 12, 9, K, 3, depth_exact)
        for a, b in zip(t, j):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert int(j[1].max()) > K  # some tiles over the cap
        assert int(j[2]) > 0        # span-clamp drops
        if not depth_exact:
            assert int(j[3]) > 0    # same-quantum ties counted

    def test_depthkey_three_keys(self):
        """depth_exact where the low depth bits and the index do not fit
        one int31 (a 32768-tile grid, > 2^15 Gaussians): the JAX
        3-operand sort against the port's stable Gaussian-major sort."""
        ntx, nty, n = 256, 128, 33000
        rects, valid, depth = selection_inputs(7, n, ntx, nty, max_span=2)
        T = ntx * nty
        depth_bits = min(22, 31 - (T + 1).bit_length())
        assert (31 - depth_bits) + (n - 1).bit_length() > 31  # not pack_exact
        t, j = run_selection(rects, valid, depth, ntx, nty, 128, 1, True)
        for a, b in zip(t, j):
            assert np.array_equal(a.numpy(), np.asarray(b))

    def test_visible_cap_drops(self):
        rng = np.random.default_rng(8)
        tbg = rng.uniform(0, 0.01, 50).astype(np.float32)
        counts = rng.integers(0, 300, 50).astype(np.int32)
        t = ttiles.visible_cap_drops(torch.from_numpy(tbg), torch.from_numpy(counts), 128)
        j = jtiles.visible_cap_drops(jnp.asarray(tbg), jnp.asarray(counts), 128)
        assert int(t) == int(j)


class TestExtractPlain:
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    @pytest.mark.parametrize("kk", [128, 256])
    def test_matches_pallas_kernel(self, dtype, kk):
        rng = np.random.default_rng(kk)
        m = 5000
        stream = rng.integers(0, 1 << 30, m).astype(np.int32)
        if dtype is np.float32:
            stream = rng.normal(size=m).astype(np.float32)
        starts = np.sort(np.concatenate(
            [rng.integers(0, m + 1, 40), [0, 1, 127, 128, 129, m - 1, m]]
        )).astype(np.int32)
        j = j_extract_slices(jnp.asarray(stream), jnp.asarray(starts), kk, interpret=True)
        t = extract.extract_slices(torch.from_numpy(stream), torch.from_numpy(starts), kk)
        assert t.dtype == torch.from_numpy(stream).dtype
        assert np.array_equal(t.numpy(), np.asarray(j))

    def test_any_kk(self):
        """Unlike the TPU kernel, any window length works."""
        stream = torch.arange(1, 301, dtype=torch.int32)
        starts = torch.tensor([0, 5, 290, 300], dtype=torch.int32)
        out = extract.extract_slices(stream, starts, 37)
        pad = np.concatenate([stream.numpy(), np.zeros(37, np.int32)])
        ref = np.stack([pad[s : s + 37] for s in starts.numpy()])
        assert np.array_equal(out.numpy(), ref)

    @pytest.mark.parametrize("dtype,fill", [(np.int32, -1), (np.float32, np.inf)])
    @pytest.mark.parametrize("kk", [128, 256])
    def test_counts_fill_match_pallas_kernel(self, dtype, fill, kk):
        """The caller's epilogue folded into K1: counts and fill against
        the Pallas kernel followed by the JAX selection's live mask and
        where (d3ga_tpu/raster/tiles.py's ids with -1, depths with inf)."""
        rng = np.random.default_rng(kk + 1)
        m = 3000
        stream = rng.integers(-(1 << 31), 1 << 31, m).astype(np.int32)
        if dtype is np.float32:
            stream = rng.normal(size=m).astype(np.float32)
        starts = np.sort(np.concatenate(
            [rng.integers(0, m + 1, 24), [0, 3, 129, m - kk // 2, m - 1, m]]
        )).astype(np.int32)
        counts = rng.integers(0, kk + 30, starts.size).astype(np.int32)
        counts[:3] = (0, kk, kk + 7)
        j = j_extract_slices(jnp.asarray(stream), jnp.asarray(starts), kk, interpret=True)
        live = jnp.arange(kk)[None] < jnp.minimum(jnp.asarray(counts), kk)[:, None]
        j = jnp.where(live, j, jnp.asarray(fill, dtype))
        t = extract.extract_slices(torch.from_numpy(stream), torch.from_numpy(starts), kk,
                                   torch.from_numpy(counts), fill)
        assert t.dtype == torch.from_numpy(stream).dtype
        assert np.array_equal(t.numpy().view(np.int32), np.asarray(j).view(np.int32))

    def test_plain_on_edge_inputs(self):
        """K1's edge inputs (chip_smoke.k1_edge_cases: kk 1, 3, 37, 256,
        starts not a multiple of 4, windows over m, counts 0 and > kk)
        against a per-element numpy reference, bit for bit."""
        from chip_smoke import k1_edge_cases

        before = extract.launches
        for name, stream, starts, kk, counts, fill in k1_edge_cases(torch.device("cpu")):
            s, st = stream.numpy(), starts.numpy()
            lim = np.full(st.size, kk) if counts is None else np.minimum(counts.numpy(), kk)
            ref = np.zeros((st.size, kk), s.dtype)
            for t in range(st.size):
                for j in range(kk):
                    p = st[t] + j
                    ref[t, j] = fill if j >= lim[t] else (s[p] if p < s.size else 0)
            out = extract.extract_slices(stream, starts, kk, counts, fill)
            assert np.array_equal(out.numpy().view(np.int32), ref.view(np.int32)), name
        assert extract.launches == before

    @pytest.mark.parametrize("dtype,fill", [(torch.int32, -1), (torch.int32, 7),
                                            (torch.float32, float("inf")),
                                            (torch.float32, -0.0), (torch.float32, 0.1)])
    def test_fill_bits_as_where_converts(self, dtype, fill):
        """The fill the kernel writes is the 32-bit pattern torch.where
        gives the plain version."""
        ref = torch.where(torch.tensor([False]), torch.zeros(1, dtype=dtype), fill)
        assert extract._fill_bits(fill, dtype) == int(ref.view(torch.int32)) & 0xFFFFFFFF

    def test_baseline_and_floor_need_the_card(self):
        stream = torch.arange(10, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            extract.extract_slices_baseline(stream, stream[:2], 4)
        with pytest.raises(ValueError, match="CUDA"):
            extract.launch_floor(4, 256, "cpu")


def blend_inputs(seed, ntx, nty, K, n=600, c=6):
    """Packed records [n+1, 6+c] (zero sentinel row last), front-to-back
    ids [T, K] and per-tile counts covering empty, half-width and full
    tiles; opaque enough that many pixels terminate early."""
    rng = np.random.default_rng(seed)
    T = ntx * nty
    xy = rng.uniform(-8, 16 * np.array([ntx, nty]) + 8, (n, 2))
    # conics from covariances with 1-6 px standard deviations
    s = rng.uniform(2.0, 10.0, (n, 2))
    th = rng.uniform(0, np.pi, n)
    R = np.stack([np.cos(th), -np.sin(th), np.sin(th), np.cos(th)], -1).reshape(n, 2, 2)
    cov = R @ (np.eye(2) * (s**2)[:, None, :]) @ np.swapaxes(R, -1, -2)
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    opac = rng.uniform(0.5, 0.999, (n, 1))
    colors = rng.uniform(0, 1, (n, c))
    records = np.concatenate([xy, conic, opac, colors], -1).astype(np.float32)
    records_ext = np.concatenate([records, np.zeros((1, 6 + c), np.float32)])
    counts = rng.integers(0, K + 1, T)
    counts[0], counts[1 % T], counts[2 % T] = 0, K // 3, K
    idx = np.full((T, K), n, np.int32)
    for t in range(T):
        idx[t, : counts[t]] = rng.choice(n, counts[t], replace=False)
    return records_ext, idx, counts.astype(np.int32)


class TestBlendPlain:
    def test_matches_pallas_kernel(self):
        """At the serving K = 256, which also drives the Pallas kernel's
        half-width branch (tiles with <= 128 records)."""
        K, ntx, nty, C = 256, 3, 2, 6
        records_ext, idx, counts = blend_inputs(K, ntx, nty, K)
        rec_ct = jnp.swapaxes(jnp.asarray(records_ext)[jnp.asarray(idx)], 1, 2)
        j = jbct._run_forward_ct(rec_ct, jnp.asarray(counts), ntx, nty, C, interpret=True)
        t, pairs = blend_ct.blend_gather_ct_plain(
            torch.from_numpy(records_ext), torch.from_numpy(idx), torch.from_numpy(counts),
            ntx, nty, C, tile_chunk=4, count_pairs=True,
        )
        assert t.shape == j.shape == (C + 1, nty * 16, ntx * 16)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=IMG_ATOL)
        # the empty tile: no colour, T_bg = 1
        assert float(t[:C, :16, :16].abs().max()) == 0.0
        assert float(t[C, :16, :16].min()) == 1.0
        # some pixels terminated early (T < 1e-4) and skipped records
        assert float(t[C].min()) < 1e-3
        assert 0 < pairs < 256 * int(counts.sum())

    def test_wrapper_uses_plain_on_cpu(self):
        records_ext, idx, counts = blend_inputs(3, 2, 2, 128, n=300)
        args = (torch.from_numpy(records_ext), torch.from_numpy(idx), torch.from_numpy(counts))
        before = blend_ct.launches
        out = blend_ct.blend_gather_ct(*args, 2, 2, 6)
        ref = blend_ct.blend_gather_ct_plain(*args, 2, 2, 6)
        assert torch.equal(out, ref)
        assert blend_ct.launches == before

    def test_wrappers_raise_off_cpu_and_cuda(self):
        meta = torch.empty(10, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="device"):
            extract.extract_slices(meta, meta[:2], 4)
        rec = torch.empty(5, 12, device="meta")
        with pytest.raises(ValueError, match="device"):
            blend_ct.blend_gather_ct(rec, meta.reshape(1, 10), meta[:1], 1, 1, 6)


class TestRasterizeTiled:
    def test_matches_jax_champion_forward(self):
        """The whole forward at K = 256 with quantized depth keys (the
        slice test covers K = 128, depth_exact): image within atol 1e-4,
        RasterAux equal."""
        K, depth_exact = 256, False
        w, h = 80, 56
        means, cov6, opac, colors = random_scene(5, 1500, w, h)
        jcam, tcam = cameras(w, h)
        bg = np.array([1, 1, 1, 0, 0, 0], np.float32)
        jimg, jaux = jax.jit(
            lambda m, c, o, col: jtiles.rasterize_tiled(
                m, jcam, jnp.asarray(bg), cov3d=c, opacities=o, colors=col,
                max_per_tile=K, use_pallas=True, coarse="dupsort_depth", dup=3,
                depth_exact=depth_exact,
            )
        )(*map(jnp.asarray, (means, cov6, opac, colors)))
        timg, taux = ttiles.rasterize_tiled(
            *map(torch.from_numpy, (means,)), tcam, torch.from_numpy(bg),
            cov3d=torch.from_numpy(cov6), opacities=torch.from_numpy(opac),
            colors=torch.from_numpy(colors), max_per_tile=K, use_pallas=True,
            coarse="dupsort_depth", dup=3, depth_exact=depth_exact,
        )
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=IMG_ATOL)
        assert taux._fields == jaux._fields
        for f in jaux._fields:
            assert int(getattr(taux, f)) == int(getattr(jaux, f)), f
        assert int(jaux.depth_ties) > 0

    def test_other_funnels_raise(self, monkeypatch):
        """A funnel neither package has raises, and so do the JAX package's
        TPU-only routes (D3GA_REC_GRAD, D3GA_REORDER, D3GA_SELEXT) set to
        other than their defaults."""
        _, tcam = cameras(32, 32)
        args = (torch.zeros(4, 3), tcam, torch.ones(3))
        kw = dict(cov3d=torch.zeros(4, 6), opacities=torch.ones(4, 1), colors=torch.ones(4, 3))
        with pytest.raises(ValueError, match="coarse"):
            ttiles.rasterize_tiled(*args, coarse="bogus", **kw)
        for name, value in (("D3GA_REC_GRAD", "add"), ("D3GA_REORDER", "sortpayload"),
                            ("D3GA_SELEXT", "slice")):
            with monkeypatch.context() as m:
                m.setenv(name, value)
                with pytest.raises(NotImplementedError, match="ROADMAP"):
                    ttiles.rasterize_tiled(*args, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
    def test_extract_kernel_bit_exact(self, cuda_device, dtype):
        g = torch.Generator().manual_seed(0)
        stream = torch.randint(0, 1 << 30, (70000,), generator=g, dtype=torch.int32)
        if dtype == torch.float32:
            stream = torch.randn(70000, generator=g)
        starts = torch.sort(torch.randint(0, 70001, (300,), generator=g)).values.int()
        ref = extract.extract_slices_plain(stream, starts, 200)
        out = extract.extract_slices(stream.to(cuda_device), starts.to(cuda_device), 200)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref)

    def test_extract_kernel_edges(self, cuda_device):
        """K1's edge inputs: the kernel bit-equal to its plain version and
        to the baseline design (followed by the live mask and where)."""
        from chip_smoke import k1_edge_cases

        for name, stream, starts, kk, counts, fill in k1_edge_cases(cuda_device):
            out = extract.extract_slices(stream, starts, kk, counts, fill)
            ref = extract.extract_slices_plain(stream, starts, kk, counts, fill)
            base = extract.extract_slices_baseline(stream, starts, kk)
            if counts is not None:
                live = torch.arange(kk, device=cuda_device)[None] < counts.clamp(max=kk)[:, None]
                base = torch.where(live, base, fill)
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), name
            assert torch.equal(out.view(torch.int32), base.view(torch.int32)), name

    def test_blend_kernel_matches_plain(self, cuda_device):
        records_ext, idx, counts = blend_inputs(4, 5, 4, 256, n=2000)
        args = [torch.from_numpy(a).to(cuda_device) for a in (records_ext, idx, counts)]
        ref = blend_ct.blend_gather_ct_plain(*args, 5, 4, 6)
        out = blend_ct.blend_gather_ct(*args, 5, 4, 6)
        torch.cuda.synchronize()
        err = (out - ref).abs().flatten()
        assert float(torch.quantile(err, 0.999)) <= 5e-4
        assert float((err > 1e-2).float().mean()) <= 1e-3
