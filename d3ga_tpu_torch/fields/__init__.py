from d3ga_tpu_torch.fields.mlp import (  # noqa: F401
    init_mlp,
    apply_mlp,
    init_deformation_field,
    deformation_field,
    init_canonical_field,
    canonical_field,
    init_color_field,
    color_field,
    init_face_decoder,
    face_decoder,
    init_shadow_decoder,
    shadow_decoder,
    get_cond_size,
)
from d3ga_tpu_torch.fields.embeddings import (  # noqa: F401
    init_embedding,
    embedding_average,
    embedding_lookup,
)
from d3ga_tpu_torch.fields.calibration import init_camera_calibration, apply_camera_calibration  # noqa: F401
