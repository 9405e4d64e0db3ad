"""Real spherical harmonics: evaluation (degree <= 4) and rotation (bands
<= 2), the counterpart of d3ga_tpu/ops/sh.py. Band constants and
ordering follow the 3DGS CUDA computeColorFromSH.
"""

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """dirs: [..., 3] unit directions -> [..., (degree+1)**2]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full(x.shape, C0, dtype=dirs.dtype, device=dirs.device)]
    if degree >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            2.5033429417967046 * xy * (xx - yy),
            -1.7701307697799304 * yz * (3.0 * xx - yy),
            0.9461746957575601 * xy * (7.0 * zz - 1.0),
            -0.6690465435572892 * yz * (7.0 * zz - 3.0),
            0.10578554691520431 * (zz * (35.0 * zz - 30.0) + 3.0),
            -0.6690465435572892 * xz * (7.0 * zz - 3.0),
            0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
            -1.7701307697799304 * xz * (xx - 3.0 * yy),
            0.6258357354491761 * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(sh_coeffs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """sh_coeffs: [..., K, C], dirs: [..., 3] -> [..., C]; only the first
    (degree+1)**2 coefficients contribute; adds the 3DGS +0.5 offset
    (clamping is left to the caller)."""
    n_active = (degree + 1) ** 2
    basis = sh_basis(dirs, degree)
    return torch.einsum("...k,...kc->...c", basis, sh_coeffs[..., :n_active, :]) + 0.5


def sh_encoding(dirs: torch.Tensor) -> torch.Tensor:
    """View-direction encoding: the degree-3 SH basis (16 values) plus the
    raw direction (3) -> [..., 19]."""
    return torch.cat([sh_basis(dirs, 3), dirs], dim=-1)


def _rot_band1(R: torch.Tensor) -> torch.Tensor:
    """The band-1 rotation D1 = M R M^T of a [..., 3, 3] rotation, with M
    the signed permutation (x, y, z) -> (-y, z, -x) of the band-1 basis:
    D1 = S (P R P^T) S, P the plain permutation, S = diag(-1, 1, -1)."""
    P = R.new_tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    s = R.new_tensor([-1.0, 1.0, -1.0])
    return (P @ R @ P.T) * (s[:, None] * s[None, :])


def _band2_basis(dirs: torch.Tensor) -> torch.Tensor:
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(
        [
            C2[0] * x * y,
            C2[1] * y * z,
            C2[2] * (2.0 * z * z - x * x - y * y),
            C2[3] * x * z,
            C2[4] * (x * x - y * y),
        ],
        dim=-1,
    )


# five directions whose band-2 basis matrix is well conditioned
_BAND2_DIRS = ((1.0, 2.0, 3.0), (3.0, 1.0, 2.0), (2.0, 3.0, 1.0), (1.0, -1.0, 2.0),
               (2.0, 1.0, -1.0))


def rotate_sh(sh_coeffs: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """SH coefficients [N, K, C] (K >= 1) rotated by R [3, 3] or [N, 3, 3]:
    band 0 unchanged, band 1 by D1, band 2 by D2 = B(R d)^T B(d)^-T solved
    on five sample directions d (exact: band 2 is 5-dimensional), bands
    >= 3 passed through unchanged."""
    K = sh_coeffs.shape[-2]
    if R.ndim == 2:
        R = R[None]
    out = [sh_coeffs[..., :1, :]]
    if K > 1:
        out.append(_rot_band1(R) @ sh_coeffs[..., 1:4, :])
    if K > 4:
        dirs = sh_coeffs.new_tensor(_BAND2_DIRS)
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        Binv = torch.linalg.inv(_band2_basis(dirs))  # [5, 5], rows b2(d_i)
        RB = _band2_basis(torch.einsum("nij,dj->ndi", R, dirs))  # [N, 5, 5]
        D2 = RB.transpose(-1, -2) @ Binv.T
        out.append(D2 @ sh_coeffs[..., 4:9, :])
    if K > 9:
        out.append(sh_coeffs[..., 9:, :])
    return torch.cat(out, dim=-2)
