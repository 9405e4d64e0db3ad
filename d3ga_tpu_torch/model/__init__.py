from d3ga_tpu_torch.model.cage_model import (  # noqa: F401
    SILHOUETTE_COLORS,
    CageGeometry,
    build_cage_geometry,
    init_cage_params,
    cage_forward,
)
from d3ga_tpu_torch.model.mesh_model import (  # noqa: F401
    MeshGeometry,
    init_mesh_params,
    mesh_forward,
)
from d3ga_tpu_torch.model.avatar import (  # noqa: F401
    AvatarModel,
    GarmentSpec,
    avatar_forward,
    eval_layer,
    init_avatar,
    pkgs_named,
)
