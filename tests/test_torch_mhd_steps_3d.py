"""The 3D MHD steps of the port against the JAX package's on the periodic
Alfven wave (`problems/mhd_tests.py:alfven_*`, 12^3): the CTU-CT step
(castro.mhd_ctu=1: 12 HLLD solves and three rounds of edge EMFs a step)
and the RK2 flux-CT step, two steps each at half the JAX run's CFL dt,
holding the state and the three face fields; div B below 1e-11. The
helpers and tolerances of tests/test_torch_mhd_steps.py (float64 1e-10;
the JAX side op by op: jitted, its 3D CTU-CT step compiles for ~45 s)."""

import pytest

from castro_tpu.problems import mhd_tests as jmt

from castro_tpu_torch.problems import mhd_tests as tmt

from test_torch_mhd_steps import check, run_both
from test_torch_radiation import _few_threads  # noqa: F401


@pytest.mark.parametrize("ctu", [1, 0], ids=["ctu", "rk2"])
def test_alfven_3d(ctu):
    js, ts = run_both(jmt.alfven_params(n=12).with_ns("castro", mhd_ctu=ctu),
                      tmt.alfven_params(n=12).with_ns("castro", mhd_ctu=ctu),
                      jmt.alfven_init, tmt.alfven_init, steps=2)
    check(js, ts)
