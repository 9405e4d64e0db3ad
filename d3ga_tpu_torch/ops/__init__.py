from d3ga_tpu_torch.ops.quaternion import (  # noqa: F401
    quat_normalize,
    quat_to_matrix,
    matrix_to_quat,
    quat_multiply,
    axis_angle_to_matrix,
)
from d3ga_tpu_torch.ops.covariance import (  # noqa: F401
    build_scaling_rotation,
    covariance_from_scaling_rotation,
    strip_symmetric,
    unstrip_symmetric,
    inverse_sigmoid,
)
from d3ga_tpu_torch.ops.sh import (  # noqa: F401
    eval_sh,
    rgb_to_sh,
    rotate_sh,
    sh_basis,
    sh_encoding,
    sh_to_rgb,
)
from d3ga_tpu_torch.ops.posenc import positional_encoding, posenc_dim  # noqa: F401
from d3ga_tpu_torch.ops.knn import knn_mean_sq_dist  # noqa: F401
