"""Pose-conditioned MLP field heads (counterpart of d3ga_tpu/fields/mlp.py).

LeakyReLU(0.1) MLPs, 128 wide, kaiming fan-in init (a=0.1), output
layer scaled by 0.33 at init. Parameters are plain dicts
{"w": [..], "b": [..], "w_out", "b_out"} with weights stored [n_in, n_out]
like the JAX package's, so a parameter tree converts one to one
(`d3ga_tpu_torch.convert.params_from_numpy`). Initialization draws from
an explicit host `torch.Generator`.
"""

import math

import torch
import torch.nn.functional as Fn

from d3ga_tpu_torch.ops.posenc import positional_encoding, posenc_dim
from d3ga_tpu_torch.ops.sh import sh_encoding

LEAK = 0.1


def _kaiming(gen, n_in, n_out, a=LEAK):
    std = math.sqrt(2.0 / (1.0 + a * a)) / math.sqrt(n_in)
    return torch.randn(n_in, n_out, generator=gen) * std


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_mlp(gen, n_in, n_hidden, n_layers, n_out, out_scale=0.33, device="cuda"):
    """n_layers counts hidden->hidden layers (n_layers + 1 hidden linear
    layers, then the output layer)."""
    ws = [_kaiming(gen, n_in, n_hidden)]
    bs = [torch.zeros(n_hidden)]
    for _ in range(n_layers):
        ws.append(_kaiming(gen, n_hidden, n_hidden))
        bs.append(torch.zeros(n_hidden))
    bound = 1.0 / math.sqrt(n_hidden)
    p = {
        "w": ws,
        "b": bs,
        "w_out": _uniform(gen, (n_hidden, n_out), bound) * out_scale,
        "b_out": _uniform(gen, (n_out,), bound),
    }
    return {
        k: [t.to(device) for t in v] if isinstance(v, list) else v.to(device)
        for k, v in p.items()
    }


def apply_mlp(params, x):
    h = x
    for w, b in zip(params["w"], params["b"]):
        h = Fn.leaky_relu(h @ w + b, LEAK)
    return h @ params["w_out"] + params["b_out"]


def _tile(cond, n):
    """Broadcast a [D] conditioning vector to [n, D]."""
    return cond[None].expand(n, cond.shape[-1])


# DeformationField: PE(canonical node) + pose -> tanh * node_scale offsets.
def init_deformation_field(gen, cond_dim, n_hidden=128, n_layers=3, device="cuda"):
    return init_mlp(gen, cond_dim + posenc_dim(3, 7), n_hidden, n_layers, 3, device=device)


def deformation_field(params, canonical_nodes, pose, node_scale):
    P = canonical_nodes.shape[0]
    z = torch.cat([_tile(pose, P), positional_encoding(canonical_nodes, 7)], -1)
    return torch.tanh(apply_mlp(params, z)) * node_scale


# CanonicalField: [pose, scales(3), barys(4), rots(4)] -> (d_bary, d_rot, d_scale).
def init_canonical_field(gen, cond_dim, n_hidden=128, n_layers=3, bary_size=4, device="cuda"):
    n_in = cond_dim + 4 + 3 + bary_size
    return init_mlp(gen, n_in, n_hidden, n_layers, 4 + 3 + bary_size, device=device)


def canonical_field(params, rots, scales, barys, pose, scale_bary, bary_size=4):
    P = barys.shape[0]
    z = torch.cat([_tile(pose, P), scales, barys, rots], -1)
    pred = apply_mlp(params, z)
    d_bary = torch.tanh(pred[:, :bary_size]) * scale_bary
    d_rot = pred[:, bary_size : bary_size + 4]
    d_scale = pred[:, bary_size + 4 :]
    return d_bary, d_rot, d_scale


# ColorField: [viewdir SH-enc, pose, shadow, cam emb, frame emb, features]
# -> sigmoid RGB + sigmoid(0.1 + x) opacity.
def color_field_input_dim(
    n_features, cond_dim, use_pose=True, use_view_enc=True,
    frame_dim=0, camera_dim=0, shadow=False, use_only_rgb=False,
):
    if use_only_rgb:
        return n_features
    n = n_features + frame_dim + camera_dim + (1 if shadow else 0)
    if use_pose:
        n += cond_dim
    if use_view_enc:
        n += 19  # SH degree-3 basis (16) + identity (3)
    return n


def init_color_field(gen, n_in, n_hidden=128, n_layers=4, device="cuda"):
    return init_mlp(gen, n_in, n_hidden, n_layers, 4, device=device)


def color_field(
    params,
    features,
    pose=None,
    viewdirs=None,
    frame_encoding=None,
    camera_encoding=None,
    shadow=None,
    use_pose=True,
    use_view_enc=True,
    use_only_rgb=False,
):
    P = features.shape[0]
    z = features
    if not use_only_rgb:
        if frame_encoding is not None:
            z = torch.cat([_tile(frame_encoding, P), z], -1)
        if camera_encoding is not None:
            z = torch.cat([_tile(camera_encoding, P), z], -1)
        if shadow is not None:
            z = torch.cat([shadow, z], -1)
        if use_pose:
            z = torch.cat([_tile(pose, P), z], -1)
        if use_view_enc:
            z = torch.cat([sh_encoding(viewdirs), z], -1)
    pred = apply_mlp(params, z)
    rgb = torch.sigmoid(pred[:, 0:3])
    opacity = torch.sigmoid(0.1 + pred[:, 3:4])
    return rgb, opacity


# FaceDecoder: flattened face keypoints -> face embedding.
def init_face_decoder(gen, n_valid_kpts, n_hidden=128, n_layers=3, n_output=128, device="cuda"):
    return init_mlp(gen, n_valid_kpts * 3, n_hidden, n_layers, n_output, device=device)


def face_decoder(params, kpt):
    return apply_mlp(params, kpt.reshape(-1))


# ShadowDecoder: pose[6:] + PE(template verts) -> per-vertex AO in [0, 1].
# As the JAX package's: its input is 98 pose values wide by default and
# it drops the first 6 pose values, Goliath's 104-wide momentum pose,
# whatever the model's cond_dim.
def init_shadow_decoder(gen, cond_dim=98, n_hidden=128, n_layers=3, device="cuda"):
    return init_mlp(gen, cond_dim + posenc_dim(3, 7), n_hidden, n_layers, 1, device=device)


def shadow_decoder(params, pose, embedded_template):
    P = embedded_template.shape[0]
    z = torch.cat([_tile(pose[6:], P), embedded_template], -1)
    return torch.sigmoid(apply_mlp(params, z))


def get_cond_size(config) -> int:
    """Pose-conditioning width: SMPL-X 87, SMPL 72, Goliath's momentum
    pose 98 (104 values less the 6 of the root)."""
    if config.get("is_smpl_body", False):
        return {"smplx": 66 + 12 + 9, "smpl": 72}[config.get("model_type", "smplx")]
    return 98
