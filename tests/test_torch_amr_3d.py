"""The port's 3D AMR against the JAX package's, on the CPU: Sedov on 32^3
with one refined level (a 32^3 window in 64^3), float64, on the kernel
route (the wrappers run their plain versions on CPU tensors), two coarse
steps. Equal windows and masks, level states to rtol 1e-10
(tests/test_torch_amr.py:assert_same_hierarchy), jit disabled on the JAX
side (level 0 and the window share one grown shape, so JAX compiles each
operation once). The kernel wrappers are counted against the structure
chip_smoke.py holds the card's launches to.
"""

import jax

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import sedov as jsedov

from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.problems import sedov
from test_torch_amr import _few_threads, assert_same_hierarchy, step_both  # noqa: F401

# wrapper calls a coarse step with one window: level 0's step (the fused
# chain, clean_fill on the default context), two window steps (the fused
# chain, the torch-op clean + fill of an explicit context) and level 0's
# clean + fill after avgDown
PER_COARSE_STEP = {"prim_aux": 3, "flatten": 3, "trace_ppm": 9, "ctu_face": 18,
                   "clean_fill": 2}


def _params(mod):
    p = mod.make_params(n=32, dim=3, r_init=0.04, exp_energy=0.3)
    p = p.with_ns("amr", max_level=1, regrid_int=2, n_error_buf=0,
                  refinement_indicators=("denerr",))
    return p.replace(extra={"amr.denerr.field": "pressure", "amr.denerr.value_greater": 0.1})


def test_sedov_3d_kernel_route_like_jax(monkeypatch):
    calls = {name: 0 for name in PER_COARSE_STEP}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in PER_COARSE_STEP:
        monkeypatch.setattr(K, name, counted(name, getattr(K, name)))
    port = AmrSimulation(_params(sedov), problem_init=sedov.problem_init, device="cpu")
    port.init_data()
    assert port.window[1] is not None and port.window[1][1] == (32, 32, 32)
    assert tuple(port.window[1][0]) == (16, 16, 16)
    assert all(s._kernel_prim for s in port.sims)
    with jax.disable_jit():
        jamr = JAmr(_params(jsedov), problem_init=jsedov.problem_init)
        jamr.init_data()
        assert_same_hierarchy(port, jamr, what="init")
        for name in calls:
            calls[name] = 0
        step_both(port, jamr, 2)
        assert calls == {k: 2 * v for k, v in PER_COARSE_STEP.items()}
        assert_same_hierarchy(port, jamr, what="after 2 steps")
