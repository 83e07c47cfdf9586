"""The port's AMR hierarchy against the JAX package's, on the CPU, with
three levels: 2D Sedov on 32^2 with 48^2 windows in 64^2 and in 128^2
(tests/test_amr.py:243 at small size: level 2 nested in level 1's
footprint), and the port resumed from the JAX hierarchy's state
(convert.restore_hierarchy) through a regrid. Float64 with jit disabled on
the JAX side (both fine levels have one window shape, so JAX compiles each
operation for two shapes only); equal windows and masks, level states to
rtol 1e-10 (tests/test_torch_amr.py:assert_same_hierarchy).
"""

import numpy as np

import jax

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import sedov as jsedov

from castro_tpu_torch import convert
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.problems import sedov
from test_torch_amr import _few_threads, assert_same_hierarchy, step_both  # noqa: F401


def _params(mod):
    p = mod.make_params(n=32, dim=2, r_init=0.04, exp_energy=0.3)
    p = p.with_ns("amr", max_level=2, regrid_int=2, n_error_buf=1,
                  refinement_indicators=("denerr",))
    return p.replace(extra={"amr.denerr.field": "pressure",
                            "amr.denerr.relative_gradient": 0.5})


def test_three_levels_nest_like_jax():
    """Two refined levels: two coarse steps, then the port resumed from
    the JAX hierarchy for a third, after a regrid."""
    port = AmrSimulation(_params(sedov), problem_init=sedov.problem_init, device="cpu")
    port.init_data()
    with jax.disable_jit():
        jamr = JAmr(_params(jsedov), problem_init=jsedov.problem_init)
        jamr.init_data()
        assert_same_hierarchy(port, jamr, what="init")
        step_both(port, jamr, 2)
        assert_same_hierarchy(port, jamr, what="after 2 steps")
        resumed = AmrSimulation(_params(sedov), problem_init=sedov.problem_init, device="cpu")
        convert.restore_hierarchy(resumed, convert.hierarchy_to_numpy(jamr))
        step_both(resumed, jamr, 1, regrid_int=2)
        assert_same_hierarchy(resumed, jamr, what="resumed, after the regrid and 3 steps")
    for a in (port, resumed):
        (ilo1, sh1), (ilo2, sh2) = a.window[1], a.window[2]
        for k in range(2):
            assert sh1[k] < 64 and sh2[k] < 128
            assert ilo2[k] >= 2 * ilo1[k] and ilo2[k] + sh2[k] <= 2 * (ilo1[k] + sh1[k])
    assert all(np.isfinite(u.numpy()).all() for u in resumed.u)
