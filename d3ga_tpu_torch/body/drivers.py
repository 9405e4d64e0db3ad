"""Body drivers (counterpart of d3ga_tpu/body/drivers.py). Only the
camera transform of the SMPL-X driver is ported so far, the piece the
optimizable global rotation / translation needs; the drivers themselves
wait for the capture data (ROADMAP.md, queue 1: 'Capture and geometry prep').
"""

import torch

from d3ga_tpu_torch.ops.quaternion import axis_angle_to_matrix


def smplx_camera_to_world(Rh, Th, w2c, mocap: bool = True):
    """Rh [3] axis-angle, Th [3], w2c [3 or 4, 4] world -> capture camera.
    Returns the camera-to-world [4, 4] in the body frame, inv(w2c [R Th;
    0 1]) (inv(w2c) without mocap). Differentiable in Rh and Th."""
    R = axis_angle_to_matrix(Rh[None])[0]
    bottom = w2c.new_tensor([[0.0, 0.0, 0.0, 1.0]])
    A = torch.cat([w2c[:3, :4], bottom], 0)
    if not mocap:
        return torch.linalg.inv(A)
    B = torch.cat([torch.cat([R, Th.reshape(3, 1)], 1), bottom], 0)
    return torch.linalg.inv(A @ B)
