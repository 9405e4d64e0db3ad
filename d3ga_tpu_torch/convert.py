"""Carry parameters and geometry across from the JAX package.

The JAX package's parameter trees (any of its options: SH coefficients,
the shadow and face decoders, mesh garments) and geometry buffers (cage
or mesh) are plain arrays;
once turned into numpy (`jax.tree_util.tree_map(np.asarray, params)`,
`geometry._asdict()`), these functions give the port's equivalents, so
both packages can be run on identical weights and identical cages (the
VGG stack's `init_vgg19_features` tree too). The same carries gradient
trees across (`params_from_numpy`) and brings the
port's trees back (`params_to_numpy`); learning-rate trees are plain
floats on both sides. The
port's own initializers draw from a `torch.Generator` instead and are
not meant to reproduce the JAX package's random numbers.
"""

from typing import Any, Mapping, Optional

import numpy as np
import torch

from d3ga_tpu_torch.body.lbs import MomentumSkeleton
from d3ga_tpu_torch.model.cage_model import CageGeometry
from d3ga_tpu_torch.model.mesh_model import MeshGeometry
from d3ga_tpu_torch.utils.tree import tree_map

_INDEX_FIELDS = {"tetras", "triangles", "tetra_id", "cage_to_body_vertex", "skin_indices",
                 "faces", "init_face_ids"}


def _tensor(a, device, index=False):
    a = np.asarray(a)
    if index:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float32), device=device)
    return torch.as_tensor(a, device=device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts / lists of numpy arrays -> the same structure of
    float32 (or integer) tensors on `device`; a boolean scalar (the VGG
    stack's "pretrained") stays a Python bool."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    if np.ndim(tree) == 0 and np.asarray(tree).dtype == np.bool_:
        return bool(tree)
    return _tensor(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors (parameters, gradients) -> the same
    structure of numpy arrays on the host, to hold against a JAX tree."""
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, tree)


def geometry_from_numpy(
    geometry: Mapping[str, Any],
    skeleton: Optional[Mapping[str, Any]] = None,
    device="cuda",
):
    """A CageGeometry's buffers (field name -> array or None) and,
    optionally, the skeleton bound to that cage (MomentumSkeleton field
    name -> array) -> (CageGeometry, MomentumSkeleton or None).
    Index buffers become int64; `joint_parents` stays on the host."""
    return _geometry(CageGeometry, geometry, skeleton, device)


def mesh_geometry_from_numpy(
    geometry: Mapping[str, Any],
    skeleton: Optional[Mapping[str, Any]] = None,
    device="cuda",
):
    """`geometry_from_numpy` for a MeshGeometry's buffers -> (MeshGeometry,
    MomentumSkeleton or None); faces and init_face_ids become int64."""
    return _geometry(MeshGeometry, geometry, skeleton, device)


def _geometry(cls, geometry, skeleton, device):
    geom = cls(
        **{
            f: None if geometry.get(f) is None else _tensor(geometry[f], device, f in _INDEX_FIELDS)
            for f in cls._fields
        }
    )
    if skeleton is None:
        return geom, None
    skel = MomentumSkeleton(
        **{
            f: torch.as_tensor(np.asarray(skeleton[f], np.int32))
            if f == "joint_parents"
            else _tensor(skeleton[f], device, f in _INDEX_FIELDS)
            for f in MomentumSkeleton._fields
        }
    )
    return geom, skel
