"""`render_frame` with SH colours against the JAX package, on the CPU:
tests/test_torch_train_two_pass.py's case (its avatar, weights, batch and
tolerances) on a model with `use_shs` (max degree 2), its image pass
evaluating the SH coefficients at degree 0 and at degree 2 (the two-pass
branch: an SH package has no RGB to fuse), each loss term and every
parameter leaf's gradient; only the active degree's bands get one.
"""

import pytest

from test_torch_train_two_pass import avatar, run_case  # noqa: F401


@pytest.mark.parametrize("name", ["sh0", "sh2"])
def test_render_frame_sh_matches_jax(name, avatar, monkeypatch):  # noqa: F811
    run_case(name, avatar, monkeypatch)
