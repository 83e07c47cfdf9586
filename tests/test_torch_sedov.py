"""The slice end to end: the port's Simulation on the 3D Sedov blast
(n = 16) against the JAX Simulation on its XLA path, on the CPU.

Both step from the same initial state (the JAX one, handed over as numpy),
through the Simulation's step (the kernel structure, run here through the
CUDA kernels' plain versions) and through the plain structure of the JAX
package's XLA path composed from the ported modules, for outflow, symmetry
and periodic boundaries, and estimate_dt. The JAX reference runs with jit
disabled: op by op it compiles once per shape, far faster here than
compiling the whole step. `advance` and the restart are held against JAX
in tests/test_torch_driver.py.

Tolerances: float64, rtol = 1e-10 with an absolute floor of 1e-10 times the
component's largest magnitude (momenta are zero up to round-off in places);
float32, rtol = atol = 2e-5, the fused-vs-XLA budget the JAX package
already accepts (tests/test_pallas.py:41).
"""

import numpy as np
import pytest
import torch

import jax

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import sedov as jsedov

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.advection_util import ctoprim
from castro_tpu_torch.ops.ctu import ctu_hydro
from castro_tpu_torch.problems import sedov

N = 16
DT = 2e-3
STEPS = 2
BCS = {"outflow": 2, "symmetry": 3, "periodic": 0}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(mod, dtype, bc):
    p = mod.make_params(n=N, dim=3, stop_time=0.1, r_init=0.2, dtype=dtype)
    return p.with_ns("castro", lo_bc=(bc,) * 3, hi_bc=(bc,) * 3)


def _assert_close(got, ref, dtype, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if dtype == "float64":
        scale = np.abs(ref).reshape(ref.shape[0], -1).max(1)
        atol = (1e-10 * scale).reshape((-1,) + (1,) * (ref.ndim - 1))
        np.testing.assert_array_less(np.abs(got - ref), 1e-10 * np.abs(ref) + atol + 1e-300,
                                     err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5, err_msg=what)


class _Jax:
    """JAX reference runs, made once per (dtype, bc) and shared."""

    def __init__(self):
        self.runs = {}

    def get(self, dtype, bc):
        key = (dtype, bc)
        if key not in self.runs:
            with jax.disable_jit():
                js = JSim(_params(jsedov, dtype, bc), problem_init=jsedov.problem_init)
                js.init_data()
                states = [np.asarray(js.u)]
                for _ in range(STEPS):
                    u, _, bad = js._step_impl(js.u, np.dtype(dtype).type(DT), 0.0)
                    assert not bool(bad)
                    js.u = u
                    states.append(np.asarray(u))
                dt_est = float(js._estdt_impl(jax.numpy.asarray(states[0])))
            self.runs[key] = dict(states=states, ng=js.ng, dt_est=dt_est)
        return self.runs[key]


@pytest.fixture(scope="module")
def jref():
    return _Jax()


def _plain_step(sim, u, dt):
    """One step through the plain structure: ctoprim, `ctu_hydro` with
    use_kernels=False, clean + fill. Returns (u_new, min_rho, nan_flag)."""
    cfg = sim.cfg._replace(use_kernels=False)
    dtw = K.wt(dt, sim.dtype)
    q, qaux = ctoprim(u, sim.layout, sim.eos, cfg.small_dens, sim.small_temp)
    u_new = ctu_hydro(u, q, qaux, None, dtw, sim.geom, sim.layout, cfg,
                      fold_update_dt=dtw)[0]
    c = sim.params.castro
    return K.clean_fill_plain(u_new, sim.layout, sim.eos, cfg.lo_bc, cfg.hi_bc, sim.ng,
                              cfg.small_dens, sim.small_temp, c.dual_energy_eta2,
                              bool(c.normalize_species), with_status=True)


def _interior(u, ng):
    return np.asarray(u)[(slice(None),) + (slice(ng, -ng),) * 3]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bc", list(BCS), ids=list(BCS))
def test_sedov_steps_match_jax(jref, dtype, bc):
    ref = jref.get(dtype, BCS[bc])
    ng = ref["ng"]
    sim = Simulation(_params(sedov, dtype, BCS[bc]), problem_init=sedov.problem_init,
                     device="cpu")
    sim.init_data()
    if dtype == "float64":
        # in float32 the order of the init's one sum (the deposited energy,
        # 4096 cells) moves the ambient edge of the blast by ~1e-6 relative,
        # so the steps start from the JAX state
        _assert_close(sim.interior(), _interior(ref["states"][0], ng), dtype, "init")
    for structure, step in (("kernel", sim._step_impl),
                            ("plain", lambda u_, dt_: _plain_step(sim, u_, dt_))):
        u = convert.state_from_numpy(ref["states"][0], sim.layout, "cpu", sim.dtype)
        for k in range(STEPS):
            u, min_rho, bad = step(u, DT)
            assert not bool(bad) and float(min_rho) > 0.0
            _assert_close(sim.interior(u), _interior(ref["states"][k + 1], ng), dtype,
                          f"{structure} structure, step {k + 1}")


def test_estimate_dt_matches_jax(jref):
    ref = jref.get("float64", BCS["outflow"])
    sim = Simulation(_params(sedov, "float64", 2), problem_init=sedov.problem_init,
                     device="cpu")
    sim.u = convert.state_from_numpy(ref["states"][0], sim.layout, "cpu", sim.dtype)
    assert sim.estimate_dt() == pytest.approx(ref["dt_est"] * sim.params.castro.init_shrink,
                                              rel=1e-12)
