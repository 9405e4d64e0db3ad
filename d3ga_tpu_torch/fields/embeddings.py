"""Learned per-frame / per-camera embedding codes (counterpart of
d3ga_tpu/fields/embeddings.py): an [N, D] table, N(0, 0.1) init,
renormalized at lookup to max_norm = D; the frame's (or camera's) code
in training, the mean code at eval.
"""

import torch


def init_embedding(gen, n_frames: int, n_dims: int, std: float = 0.1, device="cuda"):
    return {"table": (torch.randn(n_frames, n_dims, generator=gen) * std).to(device)}


def _renorm(rows):
    max_norm = float(rows.shape[-1])
    norm = torch.linalg.norm(rows, dim=-1, keepdim=True)
    scale = torch.where(norm > max_norm, max_norm / torch.clamp(norm, min=1e-12), 1.0)
    return rows * scale


def embedding_average(params):
    """Mean code for eval-time conditioning."""
    return torch.mean(_renorm(params["table"]), dim=0)


def embedding_lookup(params, idx):
    """idx: an int (or scalar tensor) -> [D], clamped into the table like
    the reference's out-of-range guard."""
    table = params["table"]
    i = min(max(int(idx), 0), table.shape[0] - 1)
    return _renorm(table[i])
