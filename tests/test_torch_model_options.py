"""The avatar model's SH colours against the JAX package, on the CPU (the
AO and face decoders and `eval_layer`: tests/test_torch_model_decoders.py;
the mesh primitive: tests/test_torch_mesh_model.py): the package's values,
the image `rasterize_tiled` draws from its SH coefficients at degree 2
and every parameter leaf's gradient of a weighted sum of that image,
both packages starting from JAX's `init_avatar` (`tests/torch_options.py`,
its tolerances); each option's parameter tree against JAX's; the default
mode of `avatar_forward` (training, as JAX's); the one-primitive check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.model.avatar import avatar_forward as j_avatar_forward
from d3ga_tpu.model.avatar import init_avatar as j_init_avatar
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.model.avatar import avatar_forward, init_avatar
from torch_options import (FRAME_IDX, N_GAUSS, batches, cage_pair, hold, max_grad,
                           mesh_pair)
from torch_parity import close


def test_sh_package_matches_jax():
    jmodel, tmodel, lbs_dim = cage_pair("sh")
    tparams, tg, (pkg,) = hold(jmodel, tmodel, lbs_dim, sh_degree=2)
    assert pkg["rgb"] is None and tuple(pkg["shs"].shape) == (2 * N_GAUSS, 9, 3)
    for g in tparams["garments"].values():
        for key in ("features_dc", "features_rest", "opacities"):
            assert max_grad(tparams, tg, g[key]) > 0, key


@pytest.mark.parametrize("option", ["sh", "ao_face", "mesh"])
def test_init_matches_jax_structure(option):
    """The port's `init_avatar` gives JAX's tree: the same leaves and
    shapes (the SH coefficients and opacities, the decoders, the mesh
    garments' 3-barycentric canonical field)."""
    jmodel, tmodel, _ = mesh_pair() if option == "mesh" else cage_pair(option)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    jparams = jax.eval_shape(lambda k: j_init_avatar(k, jmodel), jax.random.PRNGKey(0))
    jl, jdef = jax.tree_util.tree_flatten(jparams)
    tl, tdef = jax.tree_util.tree_flatten(tparams)
    assert jdef == tdef
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]


def test_avatar_forward_defaults_to_training():
    """Called without `training`, both packages train: the frame's own
    embedding code, not the mean (the port's weights carried to JAX)."""
    jmodel, tmodel, lbs_dim = cage_pair("rgb")
    tparams = init_avatar(torch.Generator().manual_seed(1), tmodel)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tparams))
    jb, tb = batches(jmodel, lbs_dim)
    jout = jax.jit(lambda p: {k: v for k, v in j_avatar_forward(p, jmodel, jb).items()
                              if k in ("frame_encoding", "rgb", "means3D")})(jparams)
    with torch.no_grad():
        tout = avatar_forward(tparams, tmodel, tb)
        teval = avatar_forward(tparams, tmodel, tb, training=False)
    for k, v in jout.items():
        close(tout[k], v)
    close(tout["frame_encoding"], np.asarray(jparams["frame_embeddings"]["table"])[FRAME_IDX])
    assert not torch.allclose(teval["frame_encoding"], tout["frame_encoding"])


def test_mixed_primitives_raise():
    jmodel, tmodel, lbs_dim = cage_pair("rgb")
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    mixed = tmodel._replace(garments=(tmodel.garments[0],
                                      tmodel.garments[1]._replace(primitive="mesh")))
    with pytest.raises(ValueError, match="primitive"):
        avatar_forward(tparams, mixed, batches(jmodel, lbs_dim)[1])
