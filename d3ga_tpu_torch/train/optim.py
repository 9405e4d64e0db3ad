"""Optimizer (counterpart of d3ga_tpu/train/optim.py): global-norm
gradient clipping -> Adam -> per-leaf learning rate -> MultiStep decay,
the JAX package's optax chain

    clip_by_global_norm(2.5), scale_by_adam, scale_by_lr_tree,
    scale_by_schedule(-multistep)

over a parameter tree (nested dicts and lists of tensors), optionally
behind gradient accumulation (optax.MultiSteps' running mean). Adam is
`torch.optim.Adam` with one parameter group per distinct learning rate;
its update lr * m_hat / (sqrt(v_hat) + eps) is optax's scale_by_adam
scaled by the group's rate. The clip follows optax's rule, g * c / norm
only where norm >= c (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the
norm and would not match).
"""

from typing import Sequence

import torch

from d3ga_tpu_torch.utils.tree import tree_leaves, tree_map


def multistep_schedule(base: float, milestones: Sequence[int], gamma: float):
    """PyTorch MultiStepLR semantics: lr * gamma^(#milestones passed)."""
    ms = sorted(milestones)

    def sched(step: int) -> float:
        return base * gamma ** sum(step >= m for m in ms)

    return sched


class TreeAdam:
    """The optimizer over `params`' leaves (made trainable here); `step`
    takes the gradients as a list in `tree_leaves(params)` order and
    updates the leaves in place. With grad_accum k > 1 a step is a
    micro-step: the gradients join a running mean (optax.MultiSteps'
    acc + (g - acc) / (i + 1)), and every k-th micro-step updates the
    leaves from the mean; the others change no leaf and no Adam state.
    `count` counts updates, `micro` micro-steps."""

    def __init__(self, params, lr_tree, milestones, gamma, clip_norm, b1, b2, eps,
                 grad_accum=1):
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
        self.grad_accum = int(grad_accum)
        self.micro = 0
        self.acc = None

    def lr_scale(self) -> float:
        """The schedule's factor for the next update."""
        return self.sched(self.count)

    def step(self, grads):
        """Clip, then one Adam update at the scheduled rates (with
        grad_accum, of the micro-steps' mean, on every grad_accum-th
        call). Returns the global norm before clipping of the gradients
        the update took (a tensor; nothing syncs), None on a micro-step
        that made no update."""
        if len(grads) != len(self.leaves):
            raise ValueError(f"{len(grads)} gradients for {len(self.leaves)} leaves")
        i = self.micro % self.grad_accum
        self.micro += 1
        if self.grad_accum > 1:
            if i == 0:
                self.acc = [torch.zeros_like(g) for g in grads]
            self.acc = [a + (g - a) / float(i + 1) for a, g in zip(self.acc, grads)]
            if i + 1 < self.grad_accum:
                return None
            grads, self.acc = self.acc, None
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
    averages the gradients of that many micro-steps before each update;
    the milestones, given in training iterations (micro-steps), are
    rescaled to updates, max(1, m // grad_accum), as the JAX package
    rescales them for optax.MultiSteps."""
    if grad_accum > 1:
        milestones = [max(1, m // grad_accum) for m in milestones]
    return TreeAdam(params, lr_tree, milestones, gamma, clip_norm, b1, b2, eps, grad_accum)


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


def lr_tree_from_config(params, config=None, zero_frozen=()):
    """The per-leaf learning-rate tree (floats) for an avatar parameter
    tree. config: dict of lr overrides (the `train:` section); a cage's
    own overrides go in config["cages"][name][lr_key] (features_rest
    keeps its 1/20 of the override). zero_frozen: paths (tuples of keys)
    whose subtrees get rate 0."""
    config = config or {}

    def garment_lr(cage_name, key):
        spec = DEFAULT_GARMENT_LRS.get(key, "lr")
        cage_cfg = config.get("cages", {}).get(cage_name, {})
        base = spec[0] if isinstance(spec, tuple) else spec
        if isinstance(base, str) and base in cage_cfg:
            return float(cage_cfg[base]) * (spec[1] if isinstance(spec, tuple) else 1.0)
        return _resolve(spec, config)

    def fill(lr, sub):
        return tree_map(lambda _: lr, sub)

    tree = {}
    for top, sub in params.items():
        if top == "garments":
            tree[top] = {
                name: {k: fill(garment_lr(name, k), v) for k, v in g.items()}
                for name, g in sub.items()
            }
        else:
            tree[top] = fill(_resolve(DEFAULT_TOP_LRS.get(top, "lr"), config), sub)
    for path in zero_frozen:
        node = tree
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = fill(0.0, node[path[-1]])
    return tree
