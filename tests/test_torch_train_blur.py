"""`render_frame` under `configs/goliath_axe184.yml`'s options (learnable
blur, raster_backend pallas_blend, dupsort_depth, dup 3) against the JAX
package on the CPU: tests/test_torch_train_capture.py's tests (loss
terms, every gradient leaf, the blur's leaf, the step's draws) on its
"goliath" config, with the same avatar, draws and tolerances.
"""

import pytest

from test_torch_train_capture import (  # noqa: F401
    avatar,
    run_case,
    test_gradients_match_jax,
    test_loss_terms_match_jax,
    test_new_leaves_have_gradients,
    test_step_draws_what_the_config_needs,
)


@pytest.fixture(scope="module", params=["goliath"])
def case(request, avatar):  # noqa: F811
    yield from run_case(request.param, avatar)
