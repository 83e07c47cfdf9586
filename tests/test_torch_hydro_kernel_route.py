"""The port against the JAX package on its kernel route: the JAX
Simulation with `use_pallas` on, its Pallas kernels run through the
interpreter (`pallas_kernels.INTERPRET = True`, restored in `finally`, as
tests/test_pallas.py does), float32, for 2D Sedov (cmpflx and trans_apply
kernels; the port fuses the final stage into trans_cmpflx) and 1D Sod (one
cmpflx kernel); and the restart of the port from a 1D and a 2D JAX
checkpoint. (The unfused 3D step under the interpreter takes most of a
minute on a CPU for one case; its Pallas kernels are held one by one in
tests/test_torch_kernels_unfused.py and its XLA path in
tests/test_torch_hydro_paths_3d.py.)

Helpers and tolerances of tests/test_torch_hydro_paths.py: float32 rtol =
atol = 2e-5 (tests/test_pallas.py:41); the restart runs in float64 at rtol
1e-10; interiors only.
"""

import numpy as np
import pytest

import jax

from castro_tpu.driver import io as jio
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.problems import sod as jsod

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import sod

from test_torch_hydro_paths import (_assert_close, _few_threads, _jax_states,  # noqa: F401
                                    _port_matches)

# name -> (problem, dim, n, castro overrides, steps, dt)
CASES = {
    "sedov2d-outflow": ("sedov", 2, 24, dict(), 3, 2e-3),
    "sod1d": ("sod", 1, 64, dict(), 4, 2e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax_kernel_route(case):
    pk.INTERPRET = True
    try:
        states, ng = _jax_states(CASES[case], "float32", use_pallas=True)
    finally:
        pk.INTERPRET = False
    _port_matches(CASES[case], "float32", states, ng)


@pytest.mark.parametrize("dim,idir,n", [(1, 1, 64), (2, 2, 24)])
def test_restart_from_jax_checkpoint_1d_2d(tmp_path, dim, idir, n):
    """A 1D and a 2D JAX checkpoint restart the port, which then steps as
    the JAX package does; a state of the wrong dimension is refused."""

    def params(mod):
        p = mod.make_params(n=n, dim=dim)
        return p.replace(problem={**mod.DEFAULTS, "idir": idir})

    with jax.disable_jit():
        js = JSim(params(jsod), problem_init=jsod.problem_init)
        js.init_data()
        js.run(max_step=1, verbose=False)
        path = jio.write_checkpoint(js, str(tmp_path / "chk00001"))
        js.run(max_step=3, verbose=False)
        ref = np.asarray(js.interior())
    sim = Simulation(params(sod), problem_init=sod.problem_init, device="cpu")
    convert.restart_from_jax_checkpoint(sim, path)
    assert sim.step_count == 1 and tuple(sim.u.shape[1:]) == (n + 2 * sim.ng,) * dim
    sim.run(max_step=3, verbose=False)
    _assert_close(sim.interior(), ref, "float64", "after restart")
    with pytest.raises(ValueError, match="does not match"):
        convert.state_from_numpy(np.zeros((sim.layout.NVAR, 4, 4, 4)), sim.layout, "cpu",
                                 sim.dtype)
