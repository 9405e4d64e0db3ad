"""Optimizer (counterpart of d3ga_tpu/train/optim.py): global-norm
gradient clipping -> Adam -> per-leaf learning rate -> MultiStep decay,
the JAX package's optax chain

    clip_by_global_norm(2.5), scale_by_adam, scale_by_lr_tree,
    scale_by_schedule(-multistep)

over a parameter tree (nested dicts and lists of tensors). Adam is
`torch.optim.Adam` with one parameter group per distinct learning rate;
its update lr * m_hat / (sqrt(v_hat) + eps) is optax's scale_by_adam
scaled by the group's rate. The clip follows optax's rule, g * c / norm
only where norm >= c (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the
norm and would not match).
"""

from typing import Sequence

import torch

from d3ga_tpu_torch.utils.tree import tree_leaves, tree_map

GRAD_ACCUM_TODO = "not ported yet (ROADMAP.md, queue 1: 'Model forward, the rest')"


def multistep_schedule(base: float, milestones: Sequence[int], gamma: float):
    """PyTorch MultiStepLR semantics: lr * gamma^(#milestones passed)."""
    ms = sorted(milestones)

    def sched(step: int) -> float:
        return base * gamma ** sum(step >= m for m in ms)

    return sched


class TreeAdam:
    """The optimizer over `params`' leaves (made trainable here); `step`
    takes the gradients as a list in `tree_leaves(params)` order and
    updates the leaves in place."""

    def __init__(self, params, lr_tree, milestones, gamma, clip_norm, b1, b2, eps):
        self.leaves = tree_leaves(params)
        lrs = [float(lr) for lr in tree_leaves(lr_tree)]
        if len(lrs) != len(self.leaves):
            raise ValueError(f"lr tree has {len(lrs)} leaves, params {len(self.leaves)}")
        groups = {}
        for p, lr in zip(self.leaves, lrs):
            p.requires_grad_(True)
            groups.setdefault(lr, []).append(p)
        self.opt = torch.optim.Adam(
            [{"params": ps, "lr": lr, "base_lr": lr} for lr, ps in groups.items()],
            betas=(b1, b2), eps=eps,
        )
        self.sched = multistep_schedule(1.0, milestones, gamma)
        self.clip_norm = float(clip_norm)
        self.count = 0

    def lr_scale(self) -> float:
        """The schedule's factor for the next update."""
        return self.sched(self.count)

    def step(self, grads):
        """Clip, then one Adam update at the scheduled rates. Returns the
        global gradient norm before clipping (a tensor; nothing syncs)."""
        if len(grads) != len(self.leaves):
            raise ValueError(f"{len(grads)} gradients for {len(self.leaves)} leaves")
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip_norm
        for p, g in zip(self.leaves, grads):
            p.grad = torch.where(keep, g, (g / norm) * self.clip_norm)
        scale = self.lr_scale()
        for group in self.opt.param_groups:
            group["lr"] = group["base_lr"] * scale
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return norm


def make_optimizer(
    params,
    lr_tree,
    milestones: Sequence[int] = (200_000, 350_000, 500_000),
    gamma: float = 0.33,
    clip_norm: float = 2.5,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    grad_accum: int = 1,
) -> TreeAdam:
    """lr_tree: a tree of floats congruent to params. grad_accum > 1
    (gradient averaging over micro-steps) is not ported yet."""
    if grad_accum > 1:
        raise NotImplementedError(f"grad_accum={grad_accum}: {GRAD_ACCUM_TODO}")
    return TreeAdam(params, lr_tree, milestones, gamma, clip_norm, b1, b2, eps)


DEFAULT_GARMENT_LRS = {
    # `models/cage_net.py:94-109` + config defaults
    "colors_feat": "feature_lr",
    "deformation_field": "deform_mlp_lr",
    "canonical_field": "canon_mlp_lr",
    "color_field": "color_mlp_lr",
    "opacities": "opacity_lr",
    "features_dc": "feature_lr",
    "features_rest": ("feature_lr", 1.0 / 20.0),
    "rotation": "rotation_lr",
    "scaling": "scaling_lr",
}

DEFAULT_TOP_LRS = {
    # `models/garment_net.py:113-144`
    "camera_calib": 1e-4,
    "learnable_blur": 1e-3,
    "pixel_cal": 5e-6,
    "bg_net": 0.01,
    "frame_embeddings": "lr",
    "camera_embeddings": "lr",
    "shadow_decoder": "lr",
    "face_decoder": "face_mlp_lr",
    "optimizable_rotations": 1e-3,
    "optimizable_translations": 1e-4,
    "optimizable_poses": 1e-3,
}

LR_DEFAULTS = {
    "lr": 1e-3,
    "deform_mlp_lr": 5e-4,
    "canon_mlp_lr": 5e-4,
    "color_mlp_lr": 5e-4,
    "face_mlp_lr": 5e-4,
    "feature_lr": 1e-3,
    "rotation_lr": 1e-3,
    "scaling_lr": 1e-3,
    "opacity_lr": 1e-3,
}


def _resolve(spec, config):
    if isinstance(spec, tuple):
        name, mult = spec
        return _resolve(name, config) * mult
    if isinstance(spec, str):
        return float(config.get(spec, LR_DEFAULTS.get(spec, 1e-3)))
    return float(spec)


def lr_tree_from_config(params, config=None):
    """The per-leaf learning-rate tree (floats) for an avatar parameter
    tree. config: dict of lr overrides (the `train:` section)."""
    config = config or {}

    def fill(spec, sub):
        lr = _resolve(spec, config)
        return tree_map(lambda _: lr, sub)

    tree = {}
    for top, sub in params.items():
        if top == "garments":
            tree[top] = {
                name: {k: fill(DEFAULT_GARMENT_LRS.get(k, "lr"), v) for k, v in g.items()}
                for name, g in sub.items()
            }
        else:
            tree[top] = fill(DEFAULT_TOP_LRS.get(top, "lr"), sub)
    return tree
