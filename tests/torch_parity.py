"""Shared pieces of the PyTorch-port parity tests: carrying a JAX
synthetic avatar's geometry, bound skeletons and weights across to the
port, and the comparison helper."""

import jax
import numpy as np

from d3ga_tpu.body.lbs import MomentumSkeleton as JSkeleton
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn

RTOL, ATOL = 1e-5, 1e-6
# XLA's optimization level 0: the same programs, about a third less CPU
# compile time for the JAX side's interpret-mode Pallas kernels (fusion may
# round differently, ~1e-7 relative)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit_o0(fn, *args):
    """fn jitted and compiled for args at optimization level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def bound_skeleton(pose_nodes):
    """The skeleton a JAX synthetic garment's pose closure skins with."""
    return next(
        c.cell_contents for c in pose_nodes.__closure__
        if isinstance(c.cell_contents, JSkeleton)
    )


def port_avatar(jmodel, jparams, n_garments, config_overrides=None):
    """The port's model and parameters (CPU) on the JAX avatar's geometry,
    bound skeletons and weights."""
    tmodel = port_model(jmodel, n_garments, config_overrides)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return tmodel, tparams


def port_model(jmodel, n_garments, config_overrides=None):
    """The port's model (CPU) on the JAX avatar's geometry and bound
    skeletons."""
    parts = [
        convert.geometry_from_numpy(
            {k: None if v is None else np.asarray(v) for k, v in g.geometry._asdict().items()},
            {k: np.asarray(v) for k, v in bound_skeleton(g.pose_nodes)._asdict().items()},
            device="cpu",
        )
        for g in jmodel.garments
    ]
    tmodel, _, _ = tsyn.build_synthetic_avatar(
        n_garments=n_garments, device="cpu", parts=parts, config_overrides=config_overrides
    )
    return tmodel
