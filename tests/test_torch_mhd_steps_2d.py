"""Orszag-Tang (32^2) through the PPM CTU-CT step of the port against the
JAX package's, in float64 (3 steps) and float32 (1 step); the helpers and
tolerances of tests/test_torch_mhd_steps.py (float64 1e-10, float32 rtol =
atol = 2e-5; div B below 1e-11 in float64)."""

import pytest

from test_torch_mhd_steps import orszag_tang_2d
from test_torch_radiation import _few_threads  # noqa: F401


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_orszag_tang_ctu_ppm(dtype):
    orszag_tang_2d(dict(mhd_ctu=1), dtype)
