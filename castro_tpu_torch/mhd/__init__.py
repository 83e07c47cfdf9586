"""Ideal MHD (reference `Source/mhd/`, SURVEY.md section 2.3).

Counterpart of `castro_tpu/mhd/__init__.py`: `MhdSimulation` owns a base
`Simulation` (layout, geometry, EOS, boundary fills) with the MHD solver and
the (u, face-B) state, and steps it with the CTU-CT step (`castro.mhd_ctu=1`,
the default) or the RK2 flux-CT step (`mhd_ctu=0`). The full MHD step,
with sources, reactions and retry, is `Simulation` with
`castro.do_mhd=1` (`driver/sim.py`), and on AMR `driver/amr.py`. On the
card unless `device="cpu"` is passed.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.mhd.hlld import MhdFaceState, fast_speed, hlld
from castro_tpu_torch.mhd.solver import MhdSolver, MhdState
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.stencil import interior_slice


class MhdSimulation:
    """Ideal-MHD runs: a base Simulation, the MHD solver and the (u, face-B)
    state."""

    def __init__(self, params, problem_init=None, device=None):
        """device: None = "cuda"; the tests pass "cpu". `problem_init(msim,
        u, b)` returns (u, b) with the gas energies only; the magnetic
        energy is folded in by init_data."""
        params = params.with_ns("castro", do_mhd=1)
        self.base = Simulation(params, device=device)
        self.solver = MhdSolver(self.base)
        self.problem_init = problem_init
        self.state = None
        self.t = 0.0
        self.step_count = 0
        # the CTU-CT scheme is dimension-general (3D: the reference's
        # Miniati-Martin 12-solve algorithm; 2D, 1D: its reductions);
        # mhd_ctu=0 selects the RK2 flux-CT integrator
        self._step_fn = (self.solver.step_ctu if self.base.params.castro.mhd_ctu
                         else self.solver.step_rk2)

    def step(self, state, dt):
        """One step of the configured integrator from `state` by dt."""
        return self._step_fn(state, K.wt(dt, self.base.dtype))

    def estdt(self, state=None):
        """The CFL dt of a state (default the current one), a float."""
        s = self.state if state is None else state
        return float(self.solver.estdt(s.u, s.b, self.base.params.castro.cfl))

    def init_data(self):
        base = self.base
        u = base.allocate()
        b = tuple(torch.zeros(base.grown_shape(), dtype=base.dtype, device=base.device)
                  for _ in range(3))
        if self.problem_init is not None:
            u, b = self.problem_init(self, u, b)
        b = tuple(torch.as_tensor(bb, dtype=base.dtype, device=base.device)
                  .expand(base.grown_shape()) for bb in b)
        u = self.solver._clean(self.solver.add_magnetic_energy(u.to(base.dtype), b), b)
        b = tuple(self.solver._fill_b(bb, d) for d, bb in enumerate(b))
        self.state = MhdState(u, b)
        return self.state

    def run(self, stop_time, max_step=10 ** 9, verbose=False):
        if self.state is None:
            self.init_data()
        while self.t < stop_time * (1 - 1e-12) and self.step_count < max_step:
            dt = min(self.estdt(), stop_time - self.t)
            self.state = self.step(self.state, dt)
            self.t += dt
            self.step_count += 1
            if verbose:
                print(f"MHD STEP {self.step_count} t={self.t:.4e} dt={dt:.3e}")
        return self

    def interior(self):
        return self.base.interior(self.state.u)

    def div_b_max(self):
        """The largest |div B| over the interior."""
        div = self.solver.div_b(self.state.b)
        return float(torch.abs(div[interior_slice(self.base.ng, self.base.layout.dim, 0)]).max())


__all__ = ["MhdSimulation", "MhdSolver", "MhdState", "hlld", "fast_speed", "MhdFaceState"]
