"""Per-camera affine colour calibration (counterpart of
d3ga_tpu/fields/calibration.py): w * rgb + b per camera, identity for the
held-out camera. In training the table's gradient is scaled by 0.1 with
the identity p * 0.1 + detach(p) * 0.9, which leaves the forward value
unchanged (the reference uses a backward hook).
"""

import torch

# the training branch's gradient scale on the calibration table
GRAD_SCALE = 0.1


def init_camera_calibration(n_cameras: int, device="cuda"):
    row = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0]])
    return {"corrections": row.repeat(n_cameras, 1).to(device)}


def apply_camera_calibration(
    params, rgb, camera_idx: int, identity_idx: int = 0, training: bool = False,
):
    """rgb: [N, 3] per-Gaussian colours or [3, H, W]; camera_idx: int."""
    if int(camera_idx) == int(identity_idx):
        return rgb
    p = params["corrections"][int(camera_idx)]
    if training:
        p = p * GRAD_SCALE + p.detach() * (1.0 - GRAD_SCALE)
    w, b = p[:3], p[3:]
    if rgb.ndim == 3:
        return rgb * w[:, None, None] + b[:, None, None]
    return rgb * w + b
