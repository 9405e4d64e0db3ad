"""Parity of the card probes (`d3ga_tpu_torch/probes/`) with the JAX
package's TPU probes under `tools/`, whose Pallas kernels run here in
interpret mode on the CPU.

- P1 (`tools/mxu_probe.py`): the matmul chain (2 trips of 8 products,
  aa += acc[0, 0] * 1e-30) at four of the tool's case shapes scaled down,
  and the roll + select chain along both axes with small and large shifts.
  The JAX kernels are closures in the tool, so each is rebuilt here as the
  tool builds it, with interpret=True.
- P2 (`tools/widerow_probe.py`, which runs its whole probe at import): the
  passthrough rebuilt here, on the four operand layouts scaled down.
- P3 (`tools/fused_bisect.py`): stages 0-1 against the tool's own
  `v0_writes_only` / `v1_mask_positions`; stages 2-3 against copies of its
  `v2_compact` / `v3_blend` that pass `_compact` the `mask_s` scratch it
  has taken since the tool was written (the tool's calls lack it and raise
  a TypeError), with the scratch `pallas_fused._run_forward` allocates.

Tolerances, each with its reason: the roll, the passthrough and stages 0-1
are bit-equal (the same float32 operations). The plain HIGHEST matmul
within rel L2 1e-6 of JAX's (float32 sums in another order); the plain
TF32 and 3xTF32 emulations (operands rounded as cvt.rna.tf32.f32 does)
within 2e-3 and 1e-5 of JAX's float32 product (TF32 keeps 10 mantissa
bits; 3xTF32 drops only the small x small term). Stage 2 sums up to K
records in another order: each channel within 1e-5 of its largest
|value|. Stage 3 is K9's forward: p999 abs <= 1e-5 and at most 1e-3 of
elements off by more than 1e-3, as tests/test_torch_fused.py holds K9.

The new matmul design's plan (tile, transposition) is held on the CPU for
every case of the tool, and the designs before (`matmul_v1`,
`passthrough_v1`) refuse CPU tensors. The CUDA kernels run only on the
card: the test marked `cuda` holds them, new and before, against the
plain versions and skips without a GPU.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from d3ga_tpu.raster.attic import pallas_fused as F

# tools/fused_probe.py points JAX's persistent compilation cache at the
# repo when imported; keep this process's settings as they were
_saved_cache = (jax.config.jax_compilation_cache_dir,
                jax.config.jax_persistent_cache_min_compile_time_secs)
from tools import fused_bisect as jbisect  # noqa: E402
from tools.fused_probe import make_inputs as j_make_inputs  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _saved_cache[0])
jax.config.update("jax_persistent_cache_min_compile_time_secs", _saved_cache[1])

from d3ga_tpu_torch import probes  # noqa: E402
from d3ga_tpu_torch.probes import fused_bisect, mxu, widerow  # noqa: E402
from d3ga_tpu_torch.raster import fused  # noqa: E402
from test_torch_fused import image_close  # noqa: E402

UNROLL = probes.UNROLL
TRIPS = 2
PRECISION = {"highest": jax.lax.Precision.HIGHEST, "default": jax.lax.Precision.DEFAULT,
             "high": jax.lax.Precision.HIGH}
TF32_REL_L2 = {"highest": 1e-6, "default": 2e-3, "high": 1e-5}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- P1: the matmul chain ----------------------------------------------------

def j_matmul(a, b, n, prec, contract_last):
    """tools/mxu_probe.py::matmul_case's kernel at n trips, interpreted."""
    M = a.shape[0]
    N = b.shape[0] if contract_last else b.shape[1]
    dims = (((1,), (1,)), ((), ())) if contract_last else (((1,), (0,)), ((), ()))

    def kernel(a_ref, b_ref, o_ref):
        def body(_, carry):
            acc, aa = carry
            for _ in range(UNROLL):
                acc = jax.lax.dot_general(aa, b_ref[...], dims, precision=prec,
                                          preferred_element_type=jnp.float32)
                aa = aa + acc[0, 0] * 1e-30
            return acc, aa

        acc, _ = jax.lax.fori_loop(0, n, body, (jnp.zeros((M, N), jnp.float32), a_ref[...]))
        o_ref[...] = acc

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))


# the tool's shapes, scaled down: (M, K, N, contract_last)
MATMUL_SHAPES = {
    "banded oh@vals": (32, 32, 16, False),
    "valsT@ohT": (16, 64, 48, False),
    "power": (64, 8, 64, False),
    "rgb w@colT": (64, 64, 3, True),
}


@pytest.fixture(scope="module", params=sorted(MATMUL_SHAPES))
def matmul_case(request):
    M, K, N, cl = MATMUL_SHAPES[request.param]
    a, b = (t.numpy() for t in mxu.operands(M, K, N, cl))
    return dict(a=a, b=b, cl=cl, jax=j_matmul(a, b, TRIPS, PRECISION["highest"], cl))


@pytest.mark.parametrize("prec", sorted(PRECISION))
def test_matmul_plain_matches_jax(matmul_case, prec):
    a, b, cl = (torch.from_numpy(matmul_case[k]) if k != "cl" else matmul_case[k]
                for k in ("a", "b", "cl"))
    out = mxu.matmul(a, b, TRIPS, prec, cl)  # CPU tensors: the plain version
    assert torch.equal(out, mxu.matmul_plain(a, b, TRIPS, prec, cl))
    assert rel_l2(out, matmul_case["jax"]) <= TF32_REL_L2[prec]


def test_tf32_round():
    # ulp 2^-10 at 1: 1 + 2^-11 is a tie (away from zero), 1 + 2^-12 below
    # half an ulp; 725,000 has an ulp of 512 in TF32
    x = np.array([1.0, 1 + 2.0**-11, 1 + 2.0**-12, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, -725000.0],
                 np.float32)
    want = np.array([1.0, 1 + 2.0**-10, 1.0, -(1 + 2.0**-10), 1 + 2.0**-9, -724992.0], np.float32)
    got = mxu.tf32_round(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    y = np.random.default_rng(5).normal(size=1000).astype(np.float32)
    r = mxu.tf32_round(torch.from_numpy(y)).numpy()
    assert np.all(r.view(np.int32) & 0x1FFF == 0)
    assert np.all(np.abs(r - y) <= 2.0**-11 * np.abs(y))
    big, small = mxu.tf32_split(torch.from_numpy(y))
    assert np.all(np.abs((big + small).numpy().astype(np.float64) - y) <= 2.0**-21 * np.abs(y))


# -- P1: the roll chain ------------------------------------------------------

def j_roll(x, n, shifts, axis):
    """tools/mxu_probe.py::roll_case's kernel at n trips, interpreted."""

    def kernel(a_ref, o_ref):
        def body(_, v):
            for s in shifts[:UNROLL]:
                m = pltpu.roll(v, s, axis)
                v = jnp.where(m > v, m, v * 0.999999)
            return v

        o_ref[...] = jax.lax.fori_loop(0, n, body, a_ref[...])

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(jnp.asarray(x)))


ROLLS = {  # (rows, lanes, axis, shifts): the tool's shifts, and large ones below 256
    "lanes small": (8, 256, 1, mxu.SMALL_SHIFTS),
    "lanes large": (8, 256, 1, (136, 144, 160, 192, 200, 224, 240, 255)),
    "rows small": (256, 8, 0, mxu.SMALL_SHIFTS),
    "rows large": (256, 8, 0, (129, 130, 133, 150, 181, 200, 233, 254)),
}


@pytest.mark.parametrize("case", sorted(ROLLS))
def test_roll_plain_matches_jax(case):
    R, L, axis, shifts = ROLLS[case]
    x = mxu.roll_input(R, L)
    out = mxu.roll(x, TRIPS, shifts, axis)
    assert np.array_equal(out.numpy(), j_roll(x.numpy(), TRIPS, shifts, axis))


# -- P2: the passthrough -----------------------------------------------------

def j_passthrough(x, bs):
    """tools/widerow_probe.py::passthrough, interpreted."""

    def body(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 1.000001

    spec = pl.BlockSpec((bs,) + x.shape[1:], lambda i: (i,) + (0,) * (x.ndim - 1))
    return np.asarray(pl.pallas_call(
        body, grid=(x.shape[0] // bs,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True,
    )(jnp.asarray(x)))


@pytest.mark.parametrize("shape,bs", [((8, 16, 16), 4), ((8, 2, 128), 4), ((32, 12, 4), 16),
                                      ((32, 48), 16)])
def test_passthrough_matches_jax(shape, bs):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    out = widerow.passthrough(torch.from_numpy(x), bs)
    assert np.array_equal(out.numpy(), j_passthrough(x, bs))


def test_binary_search_is_searchsorted():
    keys = torch.from_numpy(np.sort(np.random.default_rng(4).integers(0, 1000, 300))
                            .astype(np.int32))
    q = torch.arange(-5, 1010, 7, dtype=torch.int32)
    want = torch.searchsorted(keys, q).to(q.dtype)
    # the tool's extra halving takes a query above every key past the end
    want[q > keys.max()] = keys.numel() + 1
    assert torch.equal(widerow.binary_search(keys, q), want)


# -- P3: K9's forward stages -------------------------------------------------

BK, BC = 32, 3  # K, C


def v2_compact(K, C, NC, vals_ref, rects_ref, b, tK, tc, tr, out_ref, rec_s, sel_s, pos_s,
               mask_s):
    """tools/fused_bisect.py::v2_compact, `_compact` given its mask_s."""
    tri_c, tri_r = tc[...], tr[...]
    iota_win = jax.lax.broadcasted_iota(jnp.float32, (F.CHUNK, F.CHUNK), 0)
    vals3, rects = vals_ref.at[0], rects_ref[0]

    def tile_body(t, _):
        counts = F._compact(vals3, rects, t % F.BLOCK, t // F.BLOCK, K, NC, tri_c, tri_r,
                            iota_win, rec_s, sel_s, pos_s, mask_s)
        rec = rec_s[:K, :]
        out_ref[0, t] = jnp.broadcast_to(jnp.sum(rec, axis=0)[: C + 1][None, :],
                                         (F.P, C + 1)) + counts
        return 0

    jax.lax.fori_loop(0, F.TB, tile_body, 0)


def v3_blend(K, C, NC, vals_ref, rects_ref, b, tK, tc, tr, out_ref, rec_s, sel_s, pos_s,
             mask_s):
    """tools/fused_bisect.py::v3_blend, `_compact` given its mask_s."""
    basis, triK, tri_c, tri_r = b[...], tK[...], tc[...], tr[...]
    iota_win = jax.lax.broadcasted_iota(jnp.float32, (F.CHUNK, F.CHUNK), 0)
    vals3, rects = vals_ref.at[0], rects_ref[0]

    def tile_body(t, _):
        tx, ty = t % F.BLOCK, t // F.BLOCK
        F._compact(vals3, rects, tx, ty, K, NC, tri_c, tri_r, iota_win, rec_s, sel_s, pos_s,
                   mask_s)
        rec = rec_s[:K, :]
        coeffs_t = F._coeffs_from_rec(rec, (tx * F.TILE).astype(jnp.float32),
                                      (ty * F.TILE).astype(jnp.float32))
        out_ref[0, t] = F._blend_forward(coeffs_t, rec[:, 5][None, :], rec[:, 6 : 6 + C],
                                         basis, triK, C)
        return 0

    jax.lax.fori_loop(0, F.TB, tile_body, 0)


def j_stage(s, vals, rects, K, C):
    """tools/fused_bisect.py::run_variant's pallas_call for stage s,
    interpreted; stages 2-3 with _run_forward's scratch."""
    NB, NC = vals.shape[:2]
    kernel = (jbisect.v0_writes_only, jbisect.v1_mask_positions, v2_compact, v3_blend)[s]
    if s < 2:  # the tool's scratch
        scratch = [pltpu.VMEM((K + F.CHUNK, 16), jnp.float32),
                   pltpu.VMEM((2, NC, F.CHUNK), jnp.float32), pltpu.SMEM((NC,), jnp.float32)]
    else:
        scratch = ([pltpu.VMEM((K + F.CHUNK, 16), jnp.float32)]
                   + [pltpu.VMEM((NC, F.CHUNK), jnp.float32)] * 3)
    return np.asarray(pl.pallas_call(
        partial(kernel, K, C, NC), grid=(NB,),
        in_specs=[pl.BlockSpec((1, NC, 16, F.CHUNK), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((1, NC, F.CHUNK), lambda i: (i, 0, 0))] + F._table_specs(K, NC),
        out_specs=pl.BlockSpec((1, F.TB, F.P, C + 1), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((NB, F.TB, F.P, C + 1), jnp.float32),
        scratch_shapes=scratch, interpret=True,
    )(vals, rects, *F._tables(K, NC)))


def stage_inputs(NC):
    """tools/fused_probe.py::make_inputs (v1 layout, jnp) on one block, and
    the port's records-major tensors of the same draws."""
    vals, rects = j_make_inputs(1, NC, BC)
    rec = fused._records(torch.from_numpy(np.array(vals))).contiguous()
    return vals, rects, rec, torch.from_numpy(np.array(rects)).reshape(1, -1)


def test_make_inputs_matches_the_tool():
    vals, rects, rec, rr = stage_inputs(2)
    pv, pr = fused_bisect.make_inputs(1, 2, BC)
    assert np.array_equal(pv, rec.numpy()) and np.array_equal(pr, rr.numpy())


@pytest.mark.parametrize("s,NC", [(0, 2), (1, 2), (2, 2), (2, 1), (3, 1)])
def test_stage_plain_matches_jax(s, NC):
    vals, rects, rec, rr = stage_inputs(NC)
    want = j_stage(s, vals, rects, BK, BC)
    got = fused_bisect.stage(rec, rr, BK, BC, s).numpy()  # CPU tensors: the plain version
    assert got.shape == want.shape
    if s < 2:
        assert np.array_equal(got, want)
    elif s == 2:
        err = np.abs(got - want).max(axis=(0, 1, 2)) / np.abs(want).max(axis=(0, 1, 2))
        assert err.max() <= 1e-5
    else:
        image_close(got, want)


def test_stage3_is_k9():
    _, _, rec, rr = stage_inputs(2)
    tiles, _ = fused.select_blend(rec, rr, BK, BC)
    assert torch.equal(fused_bisect.stage(rec, rr, BK, BC, 3), tiles)


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="one of 0-3"):
        fused_bisect.stage(torch.zeros(1, 128, 16), torch.zeros(1, 128, dtype=torch.int32), 8,
                           3, 4)
    with pytest.raises(ValueError, match="precision"):
        mxu.matmul(torch.zeros(4, 4), torch.zeros(4, 4), 1, "bf16")
    with pytest.raises(ValueError, match="contraction"):
        mxu.matmul(torch.zeros(4, 4), torch.zeros(5, 4), 1)
    with pytest.raises(ValueError, match="shifts"):
        mxu.roll(torch.zeros(8, 16), 1, (1, 2, 3, 4, 5, 6, 7, 16), 1)
    with pytest.raises(ValueError, match="multiple of bs"):
        widerow.passthrough(torch.zeros(6, 4), 4)


@pytest.mark.parametrize("case", mxu.CASES, ids=[c[0] for c in mxu.CASES])
def test_matmul_plan(case):
    """The new design's plan for each of the tool's cases: transposed
    where M is 16 and N wider (the 64-row tiles fill with N's rows); the
    tile's columns the smallest of 8 (tensor cores only), 16 and 128 that
    hold the product's, so N 3 pads to 8 (16 in FP32) and nothing pads
    past a tile; the tiles and k-tiles of 32 that cover it."""
    _, M, K, N, prec, _ = case
    p = mxu.plan(M, K, N, prec)
    assert p["trans"] == (M == 16)
    rows, cols = (N, M) if p["trans"] else (M, N)
    assert (p["rows"], p["cols"]) == (rows, cols) and rows >= mxu.TILE_M // 2
    assert p["bn"] in mxu.TILE_NS and (p["bn"] != 8 or prec != "highest")
    assert cols <= p["bn"] or p["bn"] == mxu.TILE_NS[-1]
    smaller = [t for t in mxu.TILE_NS if t < p["bn"] and (t != 8 or prec != "highest")]
    assert all(cols > t for t in smaller)
    assert p["tiles"] == -(-rows // mxu.TILE_M) * -(-cols // p["bn"])
    assert p["k_tiles"] == -(-K // 32)


def test_matmul_plan_refuses():
    with pytest.raises(ValueError, match="multiple of 4"):
        mxu.plan(64, 30, 64, "default")
    with pytest.raises(ValueError, match="multiple of 4"):
        mxu.matmul(torch.zeros(8, 6), torch.zeros(6, 8), 1, "highest")
    with pytest.raises(ValueError, match="precision"):
        mxu.plan(64, 32, 64, "bf16")


def test_designs_before_need_the_card():
    """The designs before (`matmul_v1`, `passthrough_v1`) run on CUDA
    tensors only, and their counters stay 0 here; their inputs are checked
    as the new entry points check theirs."""
    a, b = mxu.operands(32, 32, 16)
    for prec in mxu.PRECISIONS:
        with pytest.raises(ValueError, match="CUDA"):
            mxu.matmul_v1(a, b, 1, prec)
    with pytest.raises(ValueError, match="contraction"):
        mxu.matmul_v1(torch.zeros(4, 4), torch.zeros(5, 4), 1)
    with pytest.raises(ValueError, match="CUDA"):
        widerow.passthrough_v1(torch.zeros(8, 16), 4)
    with pytest.raises(ValueError, match="multiple of bs"):
        widerow.passthrough_v1(torch.zeros(6, 4), 4)
    assert not any(mxu.v1_launches.values()) and widerow.v1_launches == 0


# -- the entry points, end to end on the CPU --------------------------------

def test_entry_points_on_cpu(capsys):
    rows = mxu.run_matmul("cpu", cases=[("t", 16, 32, 8, "high", False)], trips=(1, 2))
    probes.emit("mxu_matmul", "cpu", rows)
    probes.emit("mxu_roll", "cpu", mxu.run_roll(
        "cpu", cases=[("r", 16, 256, 1, mxu.SMALL_SHIFTS)], trips=(1, 2)))
    probes.emit("widerow", "cpu", widerow.run("cpu", iters=1, scale=64))
    assert fused_bisect.main(["--device", "cpu", "--blocks", "1", "--chunks", "1", "--k", "16",
                              "--c", "3", "--iters", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["probe"] for ln in lines] == ["mxu_matmul", "mxu_roll", "widerow", "fused_bisect"]
    assert all(ln["device"] == "cpu" and ln["card"] is None for ln in lines)
    mm = lines[0]["rows"][0]
    assert mm["one_cta"]["trips"] == [1, 2] and mm["per_sm"]["ctas"] == 1
    assert mm["bound_ns"] > 0 and np.isfinite(mm["one_cta"]["ns_per_op"])
    wr = lines[2]["rows"]
    assert [r["case"][0] for r in wr] == list("ABCDEFGH")
    assert all(r["bound_ms"] > 0 and r["ms"] > 0 for r in wr)
    st = lines[3]["rows"]
    assert [r["stage"] for r in st] == [0, 1, 2, 3, "backward"]
    assert st[-1]["device_ms"] is None  # the profiler's device time: the card only
    assert all(r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations") for r in st[:4])


# -- the kernels, on the card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain(cuda_device):
    for M, K, N, cl in MATMUL_SHAPES.values():
        a, b = mxu.operands(M, K, N, cl, device=cuda_device)
        for prec in PRECISION:
            out, ref = mxu.matmul(a, b, TRIPS, prec, cl), mxu.matmul_plain(a, b, TRIPS, prec, cl)
            assert rel_l2(out.cpu(), ref.cpu()) <= 1e-6
            assert rel_l2(out.cpu(), mxu.matmul_v1(a, b, TRIPS, prec, cl).cpu()) <= 1e-6
    x = mxu.roll_input(19, 4096, device=cuda_device)
    assert torch.equal(mxu.roll(x, TRIPS, mxu.BIG_SHIFTS, 1),
                       mxu.roll_plain(x, TRIPS, mxu.BIG_SHIFTS, 1))
    x = torch.randn(64, 32, 16, device=cuda_device)
    assert torch.equal(widerow.passthrough(x, 4), widerow.passthrough_plain(x))
    assert torch.equal(widerow.passthrough_v1(x, 4), widerow.passthrough_plain(x))
    _, _, rec, rr = stage_inputs(2)
    rec, rr = rec.to(cuda_device), rr.to(cuda_device)
    for s in range(2):
        for stage in (fused_bisect.stage, fused_bisect.stage_v1):
            assert torch.equal(stage(rec, rr, BK, BC, s),
                               fused_bisect.stage_plain(rec, rr, BK, BC, s))
    for stage in (fused_bisect.stage, fused_bisect.stage_v1):
        assert torch.equal(stage(rec, rr, BK, BC, 3), fused.select_blend(rec, rr, BK, BC)[0])
