"""The mesh primitive against the JAX package, on the CPU: two mesh
garments (JAX's `mesh_garment_from_cube`, carried across with
`convert.mesh_geometry_from_numpy`), the package's values (scales and
quaternions, no packed covariance, fm_energy 0), the image drawn from
scales + quaternions and every parameter leaf's gradient
(`tests/torch_options.py`'s `hold`, its tolerances), from JAX's
`init_avatar`; and the port's `mesh_garment_from_cube`, `checkerboard`
and `synthetic_batch` against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu_torch.data import synthetic as tsyn
from torch_options import H, N_GAUSS, W, hold, max_grad, mesh_pair
from torch_parity import close


def test_mesh_package_matches_jax():
    jmodel, tmodel, lbs_dim = mesh_pair()
    tparams, tg, (pkg,) = hold(jmodel, tmodel, lbs_dim)
    assert pkg["cov3D_precomp"] is None and tuple(pkg["scales"].shape) == (2 * N_GAUSS, 3)
    assert tuple(pkg["rotations"].shape) == (2 * N_GAUSS, 4)
    assert float(pkg["fm_energy"].sum()) == 0.0
    for name, g in tparams["garments"].items():
        for key, sub in g.items():
            assert max_grad(tparams, tg, sub) > 0, (name, key)


def test_synthetic_mesh_garment_and_batch():
    """The same surface samples, faces and skin binding as JAX's; the
    batch's pose is the port's generator's draw."""
    jgeom, jpose, _ = jsyn.mesh_garment_from_cube(n_gaussians=32, seed=3, res=2)
    tgeom, tpose, _ = tsyn.mesh_garment_from_cube(n_gaussians=32, seed=3, res=2, device="cpu")
    for f in ("faces", "init_face_ids"):
        assert np.array_equal(getattr(tgeom, f).numpy(), np.asarray(getattr(jgeom, f)))
    for f in ("template_verts", "init_barys", "init_points", "init_rotations"):
        close(getattr(tgeom, f), getattr(jgeom, f))
    lbs = (np.random.default_rng(2).normal(size=21) * 0.1).astype(np.float32)
    delta = (np.random.default_rng(3).normal(size=jgeom.template_verts.shape) * 0.01).astype(
        np.float32)
    close(tpose({"lbs": torch.from_numpy(lbs)}, torch.from_numpy(delta)),
          jpose({"lbs": jnp.asarray(lbs)}, jnp.asarray(delta)), rtol=1e-5, atol=1e-5)
    cam = tsyn.orbit_camera(0.3, W, H, device="cpu")
    b = tsyn.synthetic_batch(cam, 21, H, W, frame_idx=3, camera_idx=1)
    assert np.array_equal(b["image"].numpy(), np.asarray(jsyn.checkerboard(H, W)))
    assert torch.equal(b["lbs"], torch.randn(21, generator=torch.Generator().manual_seed(3)) * 0.1)
    assert (b["frame_idx"], b["camera_idx"]) == (3, 1) and float(b["silhouette"].mean()) == 0.5
