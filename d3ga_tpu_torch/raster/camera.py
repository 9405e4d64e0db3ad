"""Camera model, 3DGS conventions (counterpart of d3ga_tpu/raster/camera.py).

Column-vector form: `world_view @ [p, 1]` maps world -> view. znear=0.01
and zfar=100 as in 3DGS. `make_camera` builds the matrices in float64
with numpy and stores them as float32 tensors, as the JAX package does;
`camera_from_c2w` builds a camera from a camera-to-world tensor with
torch ops, so gradients reach the pose it came from (the optimizable
global rotation / translation, `model/avatar.py::resolve_camera`).
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    world_view: torch.Tensor     # [4, 4] world -> view
    full_proj: torch.Tensor      # [4, 4] world -> clip
    camera_center: torch.Tensor  # [3]
    tanfovx: torch.Tensor        # scalar
    tanfovy: torch.Tensor        # scalar
    width: int
    height: int


def projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    """Perspective projection, z in [znear, zfar] -> [0, 1]·w (float64)."""
    t_x = np.tan(0.5 * fovx)
    t_y = np.tan(0.5 * fovy)
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 1.0 / t_x
    P[1, 1] = 1.0 / t_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def world_to_view(R, T) -> np.ndarray:
    """R: [3,3] camera-to-world rotation, T: [3] world-to-view translation
    (COLMAP/3DGS convention) -> [4, 4] float64."""
    M = np.eye(4)
    M[:3, :3] = np.asarray(R, dtype=np.float64).T
    M[:3, 3] = np.asarray(T, dtype=np.float64)
    return M


def make_camera(
    R, T, fovx, fovy, width, height, znear=0.01, zfar=100.0, device="cuda"
) -> Camera:
    # float32 rounding of each matrix before the product, as the JAX
    # package multiplies its float32 arrays
    wv = world_to_view(R, T).astype(np.float32)
    proj = projection_matrix(znear, zfar, fovx, fovy).astype(np.float32)
    full = proj @ wv
    center = np.linalg.inv(wv.astype(np.float64))[:3, 3]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(
        world_view=t(wv),
        full_proj=t(full),
        camera_center=t(center),
        tanfovx=t(np.tan(0.5 * float(fovx))),
        tanfovy=t(np.tan(0.5 * float(fovy))),
        width=int(width),
        height=int(height),
    )


def ndc2pix(v, size):
    """NDC [-1, 1] -> pixel coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


def focal2fov(focal, pixels):
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def projection_from_tan(tanfovx, tanfovy, znear=0.01, zfar=100.0):
    """`projection_matrix` from tan(fov / 2) float32 tensors,
    differentiable in them."""
    z = tanfovx.new_zeros(())
    depth = tanfovx.new_tensor([zfar / (zfar - znear), -(zfar * znear) / (zfar - znear)])
    return torch.stack([
        torch.stack([1.0 / tanfovx, z, z, z]),
        torch.stack([z, 1.0 / tanfovy, z, z]),
        torch.stack([z, z, depth[0], depth[1]]),
        torch.stack([z, z, z + 1.0, z]),
    ])


def camera_from_c2w(c2w, tanfovx, tanfovy, width, height, znear=0.01, zfar=100.0) -> Camera:
    """A Camera from a camera-to-world [4, 4] tensor, differentiable in
    c2w (world_view its float32 inverse)."""
    w2c = torch.linalg.inv(c2w)
    tx = torch.as_tensor(tanfovx, dtype=torch.float32, device=c2w.device)
    ty = torch.as_tensor(tanfovy, dtype=torch.float32, device=c2w.device)
    proj = projection_from_tan(tx, ty, znear, zfar)
    return Camera(
        world_view=w2c,
        full_proj=proj @ w2c,
        camera_center=c2w[:3, 3],
        tanfovx=tx,
        tanfovy=ty,
        width=int(width),
        height=int(height),
    )
