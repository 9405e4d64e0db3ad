"""The JAX kernels' outputs on the two edge cases whose alpha tests decide
by rounding, `chip_smoke.K3_ON_THRESHOLD` and `K9_ON_THRESHOLD`, kept in
`d3ga_tpu_torch/fixtures/on_threshold.npz` so that chip_smoke.py (which
runs without JAX) can report the kernels against them on the card:

- k3_image: `pallas_blend_ct._run_forward_ct` (K2's function) on the K3
  case, [C+1, H, W];
- k3_drec: `pallas_blend_ct._run_backward_ct` (K3's) for the case's
  cotangent, records-major [T, K, CR];
- k9_tiles: `attic/pallas_fused.py::_run_forward` (K9's) on the K9 case,
  [NB, 64, 256, C+1];
- k9_dvals: its `_run_backward` for the case's cotangent, records-major
  [NB, kb, 16].

The inputs are not stored: both cases are made from seeds. The JAX
kernels run in interpret mode as the parity tests run them (K2 and K3
with `G_CT` patched to 16 at XLA's level 0, K9's at the default level).
The test regenerates the outputs and holds the file to them by
`flip_close` (p999 error within 1e-5 of the largest |value|, at most 0.1%
of values off by 1e-3 of it), so an XLA upgrade that moves a rounding by
an ulp does not fail it but a stale or wrong file does. Run as a script
(`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_on_threshold.py`)
it writes the file.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu.raster.attic import pallas_fused as jf1
from d3ga_tpu_torch.raster import fused
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

KEYS = ("k3_image", "k3_drec", "k9_tiles", "k9_dvals")


def jax_outputs():
    """{key: the JAX kernel's output} for KEYS."""
    cpu = torch.device("cpu")
    _, rec, idx, counts, g, ntx, nty, C = {
        c[0]: c for c in chip_smoke.k3_edge_cases(cpu)}[chip_smoke.K3_ON_THRESHOLD]
    rec_ct = jnp.swapaxes(jnp.asarray(rec.numpy())[jnp.asarray(idx.numpy())], 1, 2)
    cnt, gg = jnp.asarray(counts.numpy()), jnp.asarray(g.numpy())
    saved = jbct.G_CT
    jbct.G_CT = 16
    try:
        fwd = jit_o0(lambda r, c: jbct._run_forward_ct(r, c, ntx, nty, C, interpret=True),
                     rec_ct, cnt)
        bwd = jit_o0(lambda r, c, x: jbct._run_backward_ct(r, c, x, ntx, nty, C, interpret=True),
                     rec_ct, cnt, gg)
        out = {"k3_image": np.asarray(fwd(rec_ct, cnt)),
               "k3_drec": np.swapaxes(np.asarray(bwd(rec_ct, cnt, gg)), 1, 2)}
    finally:
        jbct.G_CT = saved
    _, vals, rects, g9, C9 = {
        c[0]: c for c in chip_smoke.k9_edge_cases(cpu)}[chip_smoke.K9_ON_THRESHOLD]
    nb, kb, _ = vals.shape
    v1 = (np.ascontiguousarray(vals.numpy().reshape(nb, kb // 128, 128, 16).transpose(0, 1, 3, 2)),
          np.ascontiguousarray(rects.numpy().reshape(nb, kb // 128, 128)))
    args = tuple(jnp.asarray(a) for a in (*v1, g9.numpy()))
    K = chip_smoke.K9_EDGE_K
    tiles = jax.jit(lambda v, r: jf1._run_forward(v, r, K, C9, True))(*args[:2])[0]
    dv = jax.jit(lambda v, r, x: jf1._run_backward(v, r, x, K, C9, True))(*args)
    out["k9_tiles"] = np.asarray(tiles)
    out["k9_dvals"] = fused._records(torch.from_numpy(np.array(dv))).numpy()
    return out


def test_fixture_is_the_jax_kernels_outputs():
    stored = np.load(chip_smoke.ON_THRESHOLD_FIXTURE)
    assert sorted(stored.files) == sorted(KEYS)
    for k, v in jax_outputs().items():
        assert stored[k].shape == v.shape and stored[k].dtype == np.float32, k
        flip_close(stored[k], v)


if __name__ == "__main__":
    np.savez_compressed(chip_smoke.ON_THRESHOLD_FIXTURE, **jax_outputs())
    print(f"wrote {chip_smoke.ON_THRESHOLD_FIXTURE}", file=sys.stderr)
