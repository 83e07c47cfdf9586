"""Single-level simulation driver: the Castro advance loop on one device.

Counterpart of `castro_tpu/driver/sim.py` (reference `Castro::advance` /
`do_advance_ctu` / retry, `Source/driver/Castro_advance.cpp:20`,
`Castro_advance_ctu.cpp:16,404,504`, and the coarse-timestep loop in
`main()`, `Source/driver/main.cpp:118-214`). The state `u` always carries
its ghost zones; every step ends with clean + ghost fill.

A step has the kernel structure of the JAX package on its accelerator
(`ops/ctu.py`, `ops/kernels.py`), chosen as `castro_tpu/driver/sim.py:
232-260` chooses it. In 3D: prim_aux, then either the fused chain
(flatten, 3 trace_ppm, 3 paired ctu_face corner stages, 3 ctu_face final
stages with consup; with PLM a torch-op trace and 3 more ctu_face launches
for the 1D solves; with a flux limiter the finals leave consup to torch
ops) or, with `riemann_solver=1` or `hybrid_riemann`, the unfused one
(flatten, 3 trace_ppm, torch-op Riemann solves, 18 trans_apply, 3 consup),
then clean_fill (torch ops with `speed_limit` or a `problem_fill` hook). In
1D and 2D ctoprim, the trace, the Courant check, the status checks and
clean + fill are torch ops and only the Riemann and transverse stages are
kernels. With `transverse_use_eos` the whole step takes the plain structure,
the JAX package's own route for that option (its EOS re-evaluation rides
the XLA transverse path). On the card (`device="cuda"`, the default) each
kernel is a CUDA kernel; on the CPU it runs its plain PyTorch version.
The 2D RZ geometric source runs through the source path of the step
(old-time sources traced into the states, the time-centred corrector).
Other sources, reactions, radiation, MHD, SDC, AMR and I/O are not ported
(ROADMAP.md); a configuration that needs them raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable, List, Optional

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.clean import clean_and_fill
from castro_tpu_torch.driver.timestep import estdt_cfl
from castro_tpu_torch.eos import make_eos
from castro_tpu_torch.geometry import geometry_from_params, resolve_device, torch_dtype
from castro_tpu_torch.network import make_network
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.ctu import HydroConfig, ctu_hydro
from castro_tpu_torch.ops.fill import fill_ghosts
from castro_tpu_torch.ops.stencil import interior_slice
from castro_tpu_torch.sources import build_sources
from castro_tpu_torch.state import layout_from_params


@dataclass
class StepStatus:
    min_rho: float
    has_nan: bool

    @property
    def success(self) -> bool:
        return (not self.has_nan) and self.min_rho > 0.0


def _unported(params):
    """The ROADMAP.md item of the first unported feature a config needs
    (sources raise in `sources.build_sources`)."""
    c = params.castro
    checks = [
        (c.do_hydro != 1, "castro.do_hydro=0 (queue 1 item 10)"),
        (bool(c.use_shock_var),
         "use_shock_var, kernel layout generalization (queue 1 item 6)"),
        (bool(c.hybrid_momentum),
         "hybrid momenta, kernel layout generalization (queue 1 item 6)"),
        (bool(c.do_react) or c.time_integration_method != 0,
         "reactions and SDC (queue 1 items 7, 12)"),
        (bool(c.do_radiation), "radiation (queue 1 item 9)"),
        (bool(c.do_mhd), "MHD (queue 1 item 11)"),
        (params.amr.max_level > 0, "AMR (queue 1 item 5)"),
    ]
    return next((item for bad, item in checks if bad), None)


class Simulation:
    """Owns params, layout, geometry, EOS/network and the state, and runs
    the step on one device."""

    def __init__(self, params: Params, problem_init: Optional[Callable] = None,
                 device=None, problem_fill: Optional[Callable] = None):
        """device: None = "cuda"; the tests pass "cpu". `problem_fill(u, t)`
        sets the ghosts of inflow faces after every fill (reference
        problem_bc_fill)."""
        item = _unported(params)
        if item is not None:
            raise NotImplementedError(f"not ported yet: {item}, see ROADMAP.md")
        self.device = resolve_device(device)
        self.network = make_network(params)
        params = replace(params, network=replace(
            params.network, nspec=self.network.nspec,
            spec_names=self.network.spec_names, aux_names=self.network.aux_names))
        self.params = params
        self.layout = layout_from_params(params)
        self.dtype = torch_dtype(params.tpu.dtype)
        self.geom = geometry_from_params(params, self.dtype, self.device)
        self.eos = make_eos(params, self.network)
        self.problem_init = problem_init
        self.problem_fill = problem_fill
        K.check_kernel_layout(self.layout, dims=(1, 2, 3))
        K.check_kernel_eos(self.eos, self.layout)
        self.source_fns = build_sources(params, self.geom, self.layout, self.layout.ngrow)

        c = params.castro
        self.ng = self.layout.ngrow
        self.small_temp = max(c.small_temp, 1e-200)
        self.cfg = HydroConfig(
            use_flattening=bool(c.use_flattening),
            difmag=c.difmag,
            riemann_solver=c.riemann_solver,
            small_dens=max(c.small_dens, 1e-200),
            small_pres=max(c.small_pres, 1e-200),
            small_ener=1e-200,
            transverse_reset_density=bool(c.transverse_reset_density),
            transverse_reset_rhoe=bool(c.transverse_reset_rhoe),
            ppm_type=c.ppm_type,
            shock_threshold=c.shock_detection_threshold,
            hybrid_riemann=bool(c.hybrid_riemann),
            use_pslope=bool(c.use_pslope),
            plm_iorder=c.plm_limiter,
            pslope_cutoff_density=c.pslope_cutoff_density,
            limit_fluxes_on_small_dens=bool(c.limit_fluxes_on_small_dens),
            speed_limit=c.speed_limit,
            cfl=c.cfl,
            # transverse_use_eos: the reference's own route is the plain
            # structure (its EOS re-evaluation rides the XLA transverse
            # path, castro_tpu/driver/sim.py:247-249); not a fallback
            use_kernels=not c.transverse_use_eos,
            lo_bc=tuple(c.lo_bc[:self.layout.dim]),
            hi_bc=tuple(c.hi_bc[:self.layout.dim]),
            ng=self.ng,
        )
        # the 3D kernel route of prim_aux, and of clean_fill where neither
        # speed_limit nor a fill hook asks for the torch ops
        # (castro_tpu/driver/sim.py:258, :380-392)
        self._kernel_prim = self.cfg.use_kernels and self.layout.dim == 3
        self._kernel_clean_fill = (self._kernel_prim and problem_fill is None
                                   and c.speed_limit <= 0.0)
        self.t = 0.0
        self.step_count = 0
        self.dt = None
        self.u = None
        self.num_zones_advanced = 0  # FOM accounting (main.cpp:169-214)

    # -- allocation & init -------------------------------------------------
    def grown_shape(self):
        return tuple(n + 2 * self.ng for n in self.geom.n_cell)

    def allocate(self):
        return torch.zeros((self.layout.NVAR,) + self.grown_shape(), dtype=self.dtype,
                           device=self.device)

    def init_data(self):
        """Fill the state from the problem hook (reference Castro::initData,
        Castro.cpp:934), enforce UEDEN = UEINT + KE, then clean and fill."""
        u = self.allocate()
        if self.problem_init is not None:
            u = self.problem_init(self, u)
        L = self.layout
        u = u.to(self.dtype).clone()
        rho_i = torch.clamp(u[L.URHO], min=1e-300)
        ke = 0.5 * (u[L.UMX] ** 2 + u[L.UMY] ** 2 + u[L.UMZ] ** 2) / rho_i
        u[L.UEDEN] = u[L.UEINT] + ke
        self.u = self._clean_fill_impl(u)
        return self.u

    def _clean_fill_impl(self, u, with_status=False, t=0.0):
        """clean_state + ghost fill (+ the problem's inflow fill at time t);
        with_status also the pre-clean interior min density and non-finite
        flag. One kernel in 3D, else torch ops."""
        c = self.params.castro
        args = (u, self.layout, self.eos, self.cfg.lo_bc, self.cfg.hi_bc, self.ng,
                self.cfg.small_dens, self.small_temp, c.dual_energy_eta2,
                bool(c.normalize_species))
        if self._kernel_clean_fill:
            return K.clean_fill(*args, with_status=with_status)
        return clean_and_fill(*args, with_status=with_status, speed_limit=c.speed_limit,
                              problem_fill=self.problem_fill, t=t)

    # -- dt ------------------------------------------------------------------
    def _estdt_impl(self, u):
        c = self.params.castro
        return estdt_cfl(u, self.layout, self.eos, self.geom, self.ng, c.cfl)

    def estimate_dt(self) -> float:
        c = self.params.castro
        if c.fixed_dt > 0:
            return c.fixed_dt
        dt = float(self._estdt_impl(self.u))
        if self.step_count == 0:
            dt = c.initial_dt if c.initial_dt > 0 else dt * c.init_shrink
        elif self.dt is not None:
            dt = min(dt, c.change_max * self.dt)
        return min(dt, c.max_dt)

    # -- the step --------------------------------------------------------------
    def _step_impl(self, u, dt, t=0.0):
        """One CTU step of single-level hydro (reference do_advance_ctu,
        Castro_advance_ctu.cpp:16, and the source path of do_old_sources /
        do_new_sources, Castro_sources.cpp:123,185). `u` is ghost-filled on
        entry (filled again at t with a fill hook). Returns (u_new, min_rho,
        nan_flag) with the two checks as 0-d tensors: the pre-clean interior
        min density, and a flag for a non-finite state or a Courant number
        above 1 (Castro_hydro.cpp:234)."""
        L = self.layout
        c = self.params.castro
        cfg = self.cfg
        dtw = K.wt(dt, self.dtype)
        check_cfl = bool(c.check_cfl_violation)
        if self.problem_fill is not None:
            # the inflow ghosts may depend on t (castro_tpu/driver/sim.py:497)
            u = fill_ghosts(u, L, cfg.lo_bc, cfg.hi_bc, self.ng,
                            problem_fill=self.problem_fill, t=t)
        courant = None
        div_node = None
        if self._kernel_prim:
            # the Courant maximum rides the kernel over the whole grid,
            # which needs ghosts that are images of the interior (no hook)
            fold = check_cfl and self.problem_fill is None
            res = K.prim_aux(u, L, self.eos, cfg.small_dens, self.small_temp,
                             self.geom.dx, courant_dt=dtw if fold else None)
            q, qaux, div_node = res[0], res[1], res[2]
            if fold:
                courant = res[3]
        else:
            q, qaux = au.ctoprim(u, L, self.eos, cfg.small_dens, self.small_temp)

        # old-time sources S(u^n), traced into the interface states
        src_old = None
        if self.source_fns:
            src_old = torch.zeros_like(u)
            for fn in self.source_fns:
                src_old = src_old + fn(self, u, q, qaux, t, dtw)
        srcQ = None if src_old is None else au.src_to_prim(q, qaux, src_old, L)

        u_new = ctu_hydro(u, q, qaux, srcQ, dtw, self.geom, L, cfg, div_node=div_node,
                          fold_update_dt=dtw,
                          trans_eos=self.eos if c.transverse_use_eos else None)[0]
        del div_node, srcQ
        if src_old is not None:
            u_new = u_new + dtw * src_old
        u_new, min_rho, nan_flag = self._clean_fill_impl(u_new, with_status=True, t=t + dt)
        if check_cfl:
            if courant is None:
                courant = au.max_courant(q, qaux, dtw, self.geom, L, self.ng,
                                         whole_grid=self.problem_fill is None)
            nan_flag = nan_flag | (courant > 1.0)
        del q, qaux

        if self.source_fns:
            # the time-centred corrector 0.5 dt (S_new - S_old)
            if self._kernel_prim:
                q2, qaux2 = K.prim_aux(u_new, L, self.eos, cfg.small_dens, self.small_temp,
                                       self.geom.dx, with_divu=False)
            else:
                q2, qaux2 = au.ctoprim(u_new, L, self.eos, cfg.small_dens, self.small_temp)
            src_new = torch.zeros_like(u)
            for fn in self.source_fns:
                src_new = src_new + fn(self, u_new, q2, qaux2, t + dt, dtw)
            u_new = u_new + 0.5 * dtw * (src_new - src_old)
            u_new = self._clean_fill_impl(u_new, t=t + dt)
        return u_new, min_rho, nan_flag

    def try_step(self, dt: float, t: Optional[float] = None):
        """One trial step from time t (default self.t)."""
        t = self.t if t is None else t
        u_new, min_rho, nan_flag = self._step_impl(self.u, dt, t)
        # one host sync for both checks
        mr, nf = torch.stack([min_rho.to(torch.float64), nan_flag.to(torch.float64)]).tolist()
        return u_new, StepStatus(min_rho=mr, has_nan=bool(nf))

    def advance(self, dt: float) -> float:
        """Advance by dt with retry/subcycling on failure (reference
        retry_advance_ctu / subcycle_advance_ctu,
        Castro_advance_ctu.cpp:404,504). Returns the dt actually taken."""
        c = self.params.castro
        u_new, status = self.try_step(dt)
        if status.success or not c.use_retry:
            self.u = u_new
            self.t += dt
            self._count_zones(1)
            return dt
        # retry with subcycling: restore the pre-step state, re-subcycle
        dt_sub = dt * c.retry_subcycle_factor
        for _ in range(c.max_subcycles):
            t_adv = 0.0
            ok = True
            u_save = self.u
            nsub = 0
            while t_adv < dt * (1 - 1e-12):
                step_dt = min(dt_sub, dt - t_adv)
                u_new, status = self.try_step(step_dt, t=self.t + t_adv)
                if not status.success:
                    ok = False
                    break
                self.u = u_new
                t_adv += step_dt
                nsub += 1
            if ok:
                self.t += dt
                self._count_zones(nsub)
                return dt
            self.u = u_save
            dt_sub *= c.retry_subcycle_factor
            if dt_sub < c.dt_cutoff:
                break
        raise RuntimeError(
            f"advance failed at t={self.t}: dt_sub={dt_sub} below cutoff "
            f"(min_rho={status.min_rho}, nan={status.has_nan})")

    def _count_zones(self, nsteps):
        self.num_zones_advanced += nsteps * int(np.prod(self.geom.n_cell))

    # -- main loop -----------------------------------------------------------
    def run(self, max_step: Optional[int] = None, stop_time: Optional[float] = None,
            verbose: Optional[bool] = None, callbacks: Optional[List[Callable]] = None):
        """The coarse-timestep loop (main.cpp:118-214) without plotfile or
        checkpoint output; prints STEP lines and the zones-per-microsecond
        figure of merit with `verbose`."""
        a = self.params.amr
        max_step = max_step if max_step is not None else (a.max_step if a.max_step >= 0 else 10 ** 9)
        stop_time = stop_time if stop_time is not None else (a.stop_time if a.stop_time >= 0 else np.inf)
        verbose = self.params.castro.v if verbose is None else verbose
        if self.u is None:
            self.init_data()
        zones0 = self.num_zones_advanced
        self._sync()
        wall0 = time.perf_counter()
        while self.step_count < max_step and self.t < stop_time * (1 - 1e-12):
            dt = self.estimate_dt()
            if self.t + dt > stop_time:
                dt = stop_time - self.t
            self.dt = self.advance(dt)
            self.step_count += 1
            if verbose:
                print(f"STEP {self.step_count} t={self.t:.6e} dt={self.dt:.6e}")
            for cb in callbacks or []:
                cb(self)
        self._sync()
        wall = time.perf_counter() - wall0
        if verbose and wall > 0:
            fom = (self.num_zones_advanced - zones0) / wall / 1e6
            print(f"  Average number of zones advanced per microsecond: {fom:.3f} "
                  f"({self.device})")
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- views -----------------------------------------------------------------
    def interior(self, u=None):
        u = self.u if u is None else u
        return u[interior_slice(self.ng, self.layout.dim)]
