"""The 2D Sedov steps of tests/test_torch_limiters.py (the positivity
limiter in float32, speed_limit, transverse_use_eos) through the port's
kernel structure (plain versions on the CPU) against the JAX XLA path; split
from that file to keep each under a minute on one worker. Tolerances as
there.
"""

import pytest

from test_torch_hydro_paths import _few_threads  # noqa: F401
from test_torch_limiters import CASES, steps_match_jax


@pytest.mark.parametrize("case", [k for k in CASES if k.endswith("2d")])
def test_steps_match_jax(case):
    steps_match_jax(case)
