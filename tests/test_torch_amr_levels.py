"""The port's AMR hierarchy against the JAX package's, on the CPU: 2D Sedov
on 32^2 with one refined level (tests/test_amr.py:92 at small size), three
steps with a regrid. Float64 with jit disabled on the JAX side; equal
windows and masks, level states to rtol 1e-10
(tests/test_torch_amr.py:assert_same_hierarchy). Its three-level case is
tests/test_torch_amr_nesting.py.
"""

import jax

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import sedov as jsedov

from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.problems import sedov
from test_torch_amr import _few_threads, assert_same_hierarchy, step_both  # noqa: F401


def _params(mod, max_level):
    p = mod.make_params(n=32, dim=2, r_init=0.08, exp_energy=0.3)
    p = p.with_ns("amr", max_level=max_level, regrid_int=2, n_error_buf=1,
                  refinement_indicators=("denerr",))
    return p.replace(extra={"amr.denerr.field": "pressure",
                            "amr.denerr.relative_gradient": 0.5})


def _both(max_level):
    port = AmrSimulation(_params(sedov, max_level), problem_init=sedov.problem_init,
                         device="cpu")
    port.init_data()
    jamr = JAmr(_params(jsedov, max_level), problem_init=jsedov.problem_init)
    jamr.init_data()
    assert_same_hierarchy(port, jamr, what="init")
    return port, jamr


def test_sedov_2d_regrid_like_jax():
    """One refined level (a 48^2 window in 64^2): three coarse steps with a
    regrid before the third; the composite mass conserved to 1e-11."""
    with jax.disable_jit():
        port, jamr = _both(1)
        assert port.window[1][1] == (48, 48)
        mass0 = float(port.composite_interior()[0].sum())
        step_both(port, jamr, 3, regrid_int=2)
        assert_same_hierarchy(port, jamr, what="after 3 steps")
    mass1 = float(port.composite_interior()[0].sum())
    assert abs(mass1 - mass0) / mass0 < 1e-11
