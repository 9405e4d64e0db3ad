"""The avatar model's AO shadow decoder and face-keypoint embedding, and
`eval_layer`, against the JAX package, on the CPU: one 2-garment cage
avatar with both decoders (Goliath's 104-wide pose, cond_dim 98; each
cage's nodes mapped one to one onto a seeded body template's positional
encoding; the face embedding 98 wide, conditioning garment 1, named
"face", so its output is used and its gradient is real), and
`eval_layer` of the "face" garment (eval mode: the mean codes). The two
packages' values and images, and every parameter leaf's gradient of the
sum of both images' weighted sums (`tests/torch_options.py`'s `hold`,
its tolerances), from JAX's `init_avatar`.
"""

from d3ga_tpu.model.avatar import avatar_forward as j_avatar_forward
from d3ga_tpu.model.avatar import eval_layer as j_eval_layer
from d3ga_tpu_torch.model.avatar import avatar_forward, eval_layer
from torch_options import N_GAUSS, cage_pair, hold, max_grad

NAMES = ["face"]


def test_decoders_and_eval_layer_match_jax():
    jmodel, tmodel, lbs_dim = cage_pair("ao_face")
    forwards = ((j_avatar_forward, avatar_forward),
                (lambda p, m, b: j_eval_layer(p, m, b, NAMES),
                 lambda p, m, b: eval_layer(p, m, b, NAMES)))
    tparams, tg, (pkg, layer) = hold(jmodel, tmodel, lbs_dim, forwards=forwards)
    for key in ("shadow_decoder", "face_decoder"):
        assert max_grad(tparams, tg, tparams[key]) > 0, key
    assert pkg["means3D"].shape[0] == 2 * N_GAUSS and layer["means3D"].shape[0] == N_GAUSS
    assert [g["name"] for g in layer["geometry"]] == NAMES
