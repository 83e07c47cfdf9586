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
Thermal diffusion, gravity (constant, monopole, Poisson), rotation, the
sponge, a problem's external source and the 2D RZ geometric source run
through the source path of the step (old-time sources traced into the
states, the time-centred corrector or a source's own, the lagged
predictor of `source_term_predictor=1`): then prim_aux runs a second time,
without div u, for the new-time primitives, and clean_fill twice. And
`point_mass_fix_solution` resets the box around the centre after a step.
With `do_react` and a reactive network the step is Strang-split: a half-dt
burn (`reactions/strang.py`) and clean + fill before the hydro update and
another after it; a failed burn fails the step and so takes the retry. An
EOS the kernels cannot evaluate (Helmholtz) sends prim_aux and clean_fill
to the torch ops, as the JAX package sends them to XLA
(`castro_tpu/driver/sim.py:258-260`); the face kernels still run. So do
hybrid momenta for clean_fill (`:384`).
`StepCtx` carries how a step fills ghosts and reduces, and its geometry:
the AMR driver (`driver/amr.py`) steps its windows through it, with the
head fill and the status reductions of an explicit context, and a
window's composite-gravity BCs. With castro.time_integration_method=2 a
step is true SDC (`sdc/__init__.py`: order 2, or 4 on Lobatto or Radau
nodes, over the MOL operators of `ops/mol.py` and `ops/fourth_order.py`,
whose Riemann solves take the cmpflx kernel); with 3 and a reacting
network it is simplified SDC, the CTU step's advective term feeding the
forced burner (`_ssdc_step_impl`). With castro.do_radiation=1 a step is
the radiation step (`_rad_step_impl`): with radiation.hydro_coupling=1
(the default) the characteristic rad-CTU step (`ops/rad_hydro.py`, torch
ops, as the JAX package leaves it to XLA) and the implicit FLD update of
`radiation/fld.py`; with hydro_coupling=0, do_hydro=0 or a multigroup run
without groups the operator-split step, the hydro step above on the
radiation layout (its Riemann solves the cmpflx and trans_cmpflx kernels
in 1D and 2D; in 3D it raises) with an upwind Er advection before the
implicit update. castro.do_hydro=0 evolves the sources alone. With
castro.do_mhd=1 a step is the MHD step (`_mhd_step_impl`, `mhd/`): the
CTU-CT step (castro.mhd_ctu=1, the default) or the RK2 flux-CT step, in
torch ops as the JAX package leaves MHD to XLA, with the same Strang
halves, old-time sources traced into the interface states and correctors;
the face fields `u_b` ride beside `u`. I/O is not ported (ROADMAP.md); a
configuration that needs it raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable, List, Optional

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.clean import clean_state, update_hybrid_momenta
from castro_tpu_torch.driver.timestep import estdt_burning, estdt_cfl, estdt_temp_diffusion
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


def _identity(x):
    return x


class StepCtx:
    """How one step fills ghosts (`fill(u, t)`), reduces (`pmin`, `pany`,
    the elementwise cross-device sum `psum`, the identity on one device) and
    where it lies (`geom`). The default context is the whole domain on one
    device; an AMR window passes its own, with its position-correct
    geometry and, for composite gravity, `grav_bc`: the (bvl, bvh) Dirichlet
    phi on the window's faces, interpolated from the coarse level's solve
    (reference Gravity.cpp:418-487); None for the isolated domain's
    multipole or periodic BCs. `point_mass` is the run-time point mass
    (accretion, Castro_pointmass.cpp:155), None for castro.point_mass
    (counterpart of `castro_tpu/driver/sim.py:StepCtx`)."""

    __slots__ = ("fill", "pmin", "pany", "psum", "geom", "grav_bc", "point_mass")

    def __init__(self, fill, pmin, pany, geom, psum=_identity, grav_bc=None,
                 point_mass=None):
        self.fill = fill
        self.pmin = pmin
        self.pany = pany
        self.psum = psum
        self.geom = geom
        self.grav_bc = grav_bc
        self.point_mass = point_mass

    def with_point_mass(self, point_mass):
        return StepCtx(self.fill, self.pmin, self.pany, self.geom, self.psum, self.grav_bc,
                       point_mass)


@dataclass
class StepStatus:
    min_rho: float
    has_nan: bool
    burn_fail: bool = False

    @property
    def success(self) -> bool:
        return (not self.has_nan) and self.min_rho > 0.0 and not self.burn_fail


def _unported(params):
    """The ROADMAP.md item of the first unported feature a config needs."""
    c = params.castro
    checks = [
        (bool(c.do_scf_initial_model),
         "castro.do_scf_initial_model, the SCF initial model (queue 1 item 10)"),
    ]
    return next((item for bad, item in checks if bad), None)


_SPLIT_3D = ("not ported yet: 3D operator-split radiation through the CTU kernels "
             "(radiation.hydro_coupling=0, or multigroup without groups, with castro.do_hydro=1 "
             "in 3D; queue 1 item 9), see ROADMAP.md")


def check_io_cadence(params):
    """Raise if a configuration asks `run` for output: plotfiles,
    checkpoints, integral sums, data logs and the phase profiler are not
    ported (queue 1 item 14)."""
    a, c = params.amr, params.castro
    asked = [name for name, on in (
        ("amr.plot_int", a.plot_int > 0), ("amr.check_int", a.check_int > 0),
        ("castro.sum_interval", c.sum_interval > 0), ("amr.data_log", bool(a.data_log)),
        ("tpu.profile", bool(params.tpu.profile))) if on]
    if asked:
        raise NotImplementedError(
            f"not ported yet: {', '.join(asked)}, the I/O cadence of run (queue 1 item 14), "
            "see ROADMAP.md")


class Simulation:
    """Owns params, layout, geometry, EOS/network and the state, and runs
    the step on one device."""

    def __init__(self, params: Params, problem_init: Optional[Callable] = None,
                 device=None, problem_fill: Optional[Callable] = None, geom=None,
                 ext_src: Optional[Callable] = None):
        """device: None = "cuda"; the tests pass "cpu". `problem_fill(u, t)`
        sets the ghosts of inflow faces after every fill (reference
        problem_bc_fill). `geom` overrides the geometry of `params`: an AMR
        window passes a `local_view` of its level, so that dx is the
        level's. `ext_src` is the problem's external source, taken with
        castro.add_ext_src=1 (reference ext_src, Castro_sources.cpp)."""
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
        self.geom = geom if geom is not None else \
            geometry_from_params(params, self.dtype, self.device)
        self.eos = make_eos(params, self.network)
        self.problem_init = problem_init
        self.problem_fill = problem_fill
        if not self.layout.mhd:
            # no kernel carries B: the MHD step is torch ops (mhd/solver.py)
            K.check_kernel_layout(self.layout, dims=(1, 2, 3), radiation=True)
        self.source_fns = build_sources(params, self.geom, self.layout, self.layout.ngrow,
                                        ext_src=ext_src)
        # radiation, gray or multigroup FLD (reference final_radiation_call,
        # Castro_advance.cpp:109; castro_tpu/driver/sim.py:159-168)
        self.rad = None
        self.u_rad = None
        if params.castro.do_radiation:
            from castro_tpu_torch.radiation.fld import FLDRadiation

            self.rad = FLDRadiation(params, self.geom, self.layout)
            self.rad.geom_metric()
            if self.layout.dim == 3 and self._rad_split() and params.castro.do_hydro:
                raise NotImplementedError(_SPLIT_3D)

        c = params.castro
        self.ng = self.layout.ngrow
        self.small_temp = max(c.small_temp, 1e-200)
        self.cfg = HydroConfig(
            use_flattening=bool(c.use_flattening),
            use_shock_var=bool(c.use_shock_var),
            hybrid_hydro=bool(c.hybrid_hydro) and self.layout.hybrid_momentum,
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
        # the 3D kernel route of prim_aux with an EOS the kernels evaluate,
        # and of clean_fill where neither hybrid momenta, speed_limit nor a
        # fill hook asks for the torch ops (castro_tpu/driver/sim.py:258-260,
        # :380-392)
        self._kernel_prim = (self.cfg.use_kernels and self.layout.dim == 3
                             and getattr(self.eos, "pallas_safe", False) and self.rad is None
                             and not self.layout.mhd)
        if self._kernel_prim:
            K.check_kernel_eos(self.eos, self.layout)
        self._kernel_clean_fill = (self._kernel_prim and problem_fill is None
                                   and not self.layout.hybrid_momentum
                                   and c.speed_limit <= 0.0)
        # ideal MHD inside the driver (reference: MHD is Castro with
        # USE_MHD=TRUE, do_advance_ctu calling construct_ctu_mhd_source,
        # Source/mhd/Castro_mhd.cpp; castro_tpu/driver/sim.py:170-181)
        self.mhd = None
        self.u_b = None
        if c.do_mhd:
            from castro_tpu_torch.mhd.solver import MhdSolver

            self.mhd = MhdSolver(self)
        # Strang reaction coupling (reactions/strang.py); the SDC modes
        # couple the reactions themselves
        self.reactor = None
        tim = c.time_integration_method
        if c.do_react and self.network.reactive and tim == 0:
            from castro_tpu_torch.reactions.strang import StrangReactor

            self.reactor = StrangReactor(params, self.network, self.eos, self.layout)
        # SDC time integration (sdc/__init__.py; castro_tpu/driver/sim.py:
        # 193-212): true SDC of order 2, or 4 on Lobatto or Radau nodes;
        # simplified SDC with a reacting network (without one,
        # time_integration_method=3 takes the CTU step)
        self.sdc = None
        self.sdc_simplified = None
        if tim == 2:
            from castro_tpu_torch.sdc import TrueSDC2, TrueSDC4, TrueSDC4Radau

            if int(c.sdc_order) >= 4:
                self.sdc = TrueSDC4Radau(self) if c.sdc_quadrature == 1 else TrueSDC4(self)
            else:
                self.sdc = TrueSDC2(self)
        elif tim == 3 and c.do_react and self.network.reactive:
            from castro_tpu_torch.sdc import SimplifiedSDC

            self.sdc_simplified = SimplifiedSDC(self)
        self._burn_fail = None
        self.t = 0.0
        self.step_count = 0
        self.dt = None
        self.u = None
        self.num_zones_advanced = 0  # FOM accounting (main.cpp:169-214)
        self.keep_fluxes = False  # AMR refluxing needs the face fluxes
        # lagged momentum dS/dt of source_term_predictor=1 (none before the
        # first step, like the reference's source corrector)
        self._src_pred = None
        # the point mass, which accretes with point_mass_fix_solution
        # (Castro_pointmass.cpp:155)
        self.point_mass = float(c.point_mass)
        self._pm_fix = bool(c.use_point_mass and c.point_mass_fix_solution)
        self._default_ctx = StepCtx(fill=self._fill, pmin=torch.min, pany=lambda b: b,
                                    geom=self.geom)

    # -- allocation & init -------------------------------------------------
    def grown_shape(self):
        return tuple(n + 2 * self.ng for n in self.geom.n_cell)

    def allocate(self):
        return torch.zeros((self.layout.NVAR,) + self.grown_shape(), dtype=self.dtype,
                           device=self.device)

    def init_data(self):
        """Fill the state from the problem hook (reference Castro::initData,
        Castro.cpp:934), enforce UEDEN = UEINT + KE, then clean and fill.
        With MHD the hook takes (sim, u, b) and returns (u, b) (reference
        problem_initialize_mhd_data.H); the magnetic energy is then folded
        into UEDEN (Castro::add_magnetic_e, Castro.H:823-850), the state
        cleaned and the face fields filled."""
        u = self.allocate()
        if self.mhd is not None:
            b = tuple(torch.zeros(self.grown_shape(), dtype=self.dtype, device=self.device)
                      for _ in range(3))
            if self.problem_init is not None:
                u, b = self.problem_init(self, u, b)
            b = tuple(torch.as_tensor(bb, dtype=self.dtype, device=self.device)
                      .expand(self.grown_shape()) for bb in b)
            self.u = self.mhd._clean(self.mhd.add_magnetic_energy(u.to(self.dtype), b), b)
            self.u_b = tuple(self.mhd._fill_b(bb, d) for d, bb in enumerate(b))
            return self.u
        if self.problem_init is not None:
            u = self.problem_init(self, u)
        L = self.layout
        u = u.to(self.dtype).clone()
        rho_i = torch.clamp(u[L.URHO], min=1e-300)
        ke = 0.5 * (u[L.UMX] ** 2 + u[L.UMY] ** 2 + u[L.UMZ] ** 2) / rho_i
        u[L.UEDEN] = u[L.UEINT] + ke
        if self.cfg.hybrid_hydro:
            # seed the (authoritative) hybrid momenta from the linear ones
            # (reference initData -> linear_to_hybrid_momentum, Castro.cpp:1154)
            u = update_hybrid_momenta(u, L, self.geom, self.ng)
        self.u = self._clean_fill_impl(u)
        if self.rad is not None and self.u_rad is None:
            # radiation in equilibrium with the matter, split over the groups
            # by Planck weight (a problem may set sim.u_rad after init_data)
            from castro_tpu_torch.utils import constants as C

            Ti = self.interior()[L.UTEMP]
            if L.ngroups > 1 and self.rad.nugroup is not None:
                self.u_rad = (self.rad.planck_weights(Ti)
                              * (C.a_rad * Ti ** 4)[None].double()).to(self.dtype)
            else:
                self.u_rad = C.a_rad * Ti ** 4
        return self.u

    def _clean_fill_impl(self, u, with_status=False, t=0.0, ctx=None):
        """clean_state + ghost fill (+ the problem's inflow fill at time t);
        with_status also the pre-clean interior min density and non-finite
        flag. One kernel in 3D on the default context, as the JAX package
        takes its fused kernel there only (`castro_tpu/driver/sim.py:382`);
        else torch ops and the context's fill."""
        c = self.params.castro
        if self._kernel_clean_fill and (ctx is None or ctx is self._default_ctx):
            return K.clean_fill(u, self.layout, self.eos, self.cfg.lo_bc, self.cfg.hi_bc,
                                self.ng, self.cfg.small_dens, self.small_temp,
                                c.dual_energy_eta2, bool(c.normalize_species),
                                with_status=with_status)
        ctx = ctx or self._default_ctx
        status = ()
        if with_status:
            inner = u[interior_slice(self.ng, self.layout.dim)]
            status = (ctx.pmin(inner[self.layout.URHO]),
                      ctx.pany(~torch.isfinite(torch.sum(inner))))
        u = clean_state(u, self.layout, self.eos, small_dens=self.cfg.small_dens,
                        small_temp=self.small_temp, dual_energy_eta2=c.dual_energy_eta2,
                        do_normalize_species=bool(c.normalize_species),
                        speed_limit=c.speed_limit)
        if self.layout.hybrid_momentum:
            if self.cfg.hybrid_hydro:
                # the hybrid momenta are authoritative: rebuild the linear
                # ones from them (Castro_hybrid.cpp hybrid_to_linear_momentum)
                from castro_tpu_torch.ops.hybrid import sync_linear_from_hybrid

                u = sync_linear_from_hybrid(u, ctx.geom, self.layout, self.ng)
            else:
                u = update_hybrid_momenta(u, self.layout, ctx.geom, self.ng)
        u = ctx.fill(u, t)
        return (u,) + status if with_status else u

    def _fill(self, u, t=0.0):
        return fill_ghosts(u, self.layout, self.cfg.lo_bc, self.cfg.hi_bc, self.ng,
                           problem_fill=self.problem_fill, t=t)

    # -- dt ------------------------------------------------------------------
    def _estdt_impl(self, u, Er=None):
        c = self.params.castro
        L = self.layout
        dt = estdt_cfl(u, self.layout, self.eos, self.geom, self.ng, c.cfl)
        dt_b = estdt_burning(u, self.layout, self.eos, self.network, self.ng, c.dtnuc_e,
                             c.dtnuc_X, c.dtnuc_X_threshold)
        if not isinstance(dt_b, float):
            dt = torch.minimum(dt, dt_b)
        diff = next((s for s in self.source_fns if getattr(s, "name", "") == "diff"), None)
        if diff is not None:
            dt = torch.minimum(dt, estdt_temp_diffusion(u, self.layout, self.eos, self.geom,
                                                        self.ng, diff))
        if self.rad is not None and Er is not None:
            # the matter-radiation coupling limit (reference estdt_rad,
            # timestep.cpp:499 / Radiation::EstTimeStep)
            ui = u[interior_slice(self.ng, L.dim)]
            rho = ui[L.URHO]
            e = ui[L.UEINT] / rho
            es = self.eos.re(rho=rho, e=e, xn=ui[L.UFS: L.UFS + L.nspec] / rho[None])
            Er_tot = torch.sum(Er, dim=0) if Er.dim() > L.dim else Er
            dt = torch.minimum(dt, self.rad.estdt(Er_tot, rho, e, es.cv, es.T))
        return dt

    def estimate_dt(self) -> float:
        c = self.params.castro
        if c.fixed_dt > 0:
            return c.fixed_dt
        if self.mhd is not None:
            dt = float(self._mhd_estdt_impl(self.u, self.u_b))
        else:
            dt = float(self._estdt_impl(self.u, self.u_rad))
        if self.step_count == 0:
            dt = c.initial_dt if c.initial_dt > 0 else dt * c.init_shrink
        elif self.dt is not None:
            dt = min(dt, c.change_max * self.dt)
        return min(dt, c.max_dt)

    def _mhd_estdt_impl(self, u, b):
        """The MHD dt limit (reference estdt_mhd, timestep.cpp:148) and the
        burning limiter (castro_tpu/driver/sim.py:1038-1046)."""
        c = self.params.castro
        dt = self.mhd.estdt(u, b, c.cfl)
        dt_b = estdt_burning(u, self.layout, self.eos, self.network, self.ng, c.dtnuc_e,
                             c.dtnuc_X, c.dtnuc_X_threshold)
        return dt if isinstance(dt_b, float) else torch.minimum(dt, dt_b)

    # -- the step --------------------------------------------------------------
    def _step_impl(self, u, dt, t=0.0, ctx: Optional[StepCtx] = None, src_pred=None,
                   point_mass=None):
        """One CTU step of single-level hydro (reference do_advance_ctu,
        Castro_advance_ctu.cpp:16, and the source path of do_old_sources /
        do_new_sources, Castro_sources.cpp:123,185). Returns (u_new, min_rho,
        nan_flag) with the two checks as 0-d tensors: the pre-clean interior
        min density, and a flag for a non-finite state or a Courant number
        above 1 (Castro_hydro.cpp:234). With `keep_fluxes` the interior face
        fluxes follow (per direction d, n+1 faces along d and the interior
        across it), and with `source_term_predictor=1` the lagged dS/dt for
        the next step comes last.

        On the default context `u` is ghost-filled on entry, and the step
        fills again only with a fill hook; an explicit context (an AMR
        window) always fills first. `src_pred` (source_term_predictor=1):
        the previous step's dS/dt; the old-time source becomes S^n + dt/2
        dS/dt (create_source_corrector, Castro.cpp:3780-3836). `point_mass`
        (point_mass_fix_solution=1): the run-time point mass, a 0-d tensor,
        which gravity reads through the context.

        Sources take the context. Their old-time terms are kept one by one:
        a source with a `corrector` (gravity) adds dt*corr from (u, u_new,
        fluxes) in place of its share of 0.5*dt*(S_new - S_old). The
        sources' memos (the gravity field of a state) are cleared at the
        start and the end of the step."""
        self._reset_sources()
        try:
            return self._step(u, dt, t, ctx, src_pred, point_mass)
        finally:
            self._reset_sources()

    def _reset_sources(self):
        for fn in self.source_fns:
            if hasattr(fn, "reset"):
                fn.reset()

    def _step(self, u, dt, t, ctx, src_pred, point_mass):
        skip_head_fill = ctx is None and self.problem_fill is None
        ctx = ctx or self._default_ctx
        if point_mass is not None:
            ctx = ctx.with_point_mass(point_mass)
        L = self.layout
        c = self.params.castro
        cfg = self.cfg
        dtw = K.wt(dt, self.dtype)
        # source-only evolution (castro.do_hydro=0) checks no Courant number
        check_cfl = bool(c.check_cfl_violation) and bool(c.do_hydro)
        if not skip_head_fill:
            u = ctx.fill(u, t)
        burn_fail = None
        if self.reactor is not None:
            # the first half-dt burn (Strang), then clean + fill
            u, _, _, burn_fail = self.reactor.react(u, 0.5 * dtw,
                                                    u[L.USHK] if L.shock_var else None)
            u = self._clean_fill_impl(u, t=t, ctx=ctx)
        courant = None
        div_node = None
        if self._kernel_prim:
            # the Courant maximum rides the kernel over the whole grid,
            # which needs ghosts that are images of the interior (no hook)
            fold = check_cfl and self.problem_fill is None
            res = K.prim_aux(u, L, self.eos, cfg.small_dens, self.small_temp,
                             ctx.geom.dx, courant_dt=dtw if fold else None)
            q, qaux, div_node = res[0], res[1], res[2]
            if fold:
                courant = res[3]
        else:
            q, qaux = au.ctoprim(u, L, self.eos, cfg.small_dens, self.small_temp)

        # old-time sources S(u^n), traced into the interface states
        src_old = None
        src_old_terms = []
        if self.source_fns:
            src_old = torch.zeros_like(u)
            for fn in self.source_fns:
                term = fn(self, u, q, qaux, t, dtw, ctx=ctx)
                # a source with its own corrector needs its term again
                src_old_terms.append(term if hasattr(fn, "corrector") else None)
                src_old = src_old + term
            del term
        src_eff = src_old
        if src_pred is not None and c.source_term_predictor == 1 and src_old is not None:
            # S^{n+1/2} = S^n + dt/2 dS/dt (the momentum rows; src_pred is
            # zero elsewhere)
            src_eff = src_old + 0.5 * dtw * src_pred
        srcQ = None if src_eff is None else au.src_to_prim(q, qaux, src_eff, L)

        if c.do_hydro:
            u_new, fluxes = ctu_hydro(u, q, qaux, srcQ, dtw, ctx.geom, L, cfg,
                                      div_node=div_node, fold_update_dt=dtw,
                                      trans_eos=self.eos if c.transverse_use_eos else None)[:2]
        else:
            # source-only evolution (reference castro.do_hydro=0;
            # castro_tpu/driver/sim.py:560-570): no fluxes, u_new = u + sources
            fluxes = [torch.zeros_like(u) for _ in range(L.dim)]
            u_new = u
        del div_node, srcQ
        if src_eff is not None:
            u_new = u_new + dtw * src_eff
        u_new, min_rho, nan_flag = self._clean_fill_impl(u_new, with_status=True, t=t + dt,
                                                         ctx=ctx)
        if check_cfl:
            if courant is None:
                courant = au.max_courant(q, qaux, dtw, ctx.geom, L, self.ng,
                                         whole_grid=self.problem_fill is None)
            nan_flag = nan_flag | ctx.pany(courant > 1.0)
        del q, qaux

        pred_out = None
        if self.source_fns:
            # the time-centred corrector 0.5 dt (S_new - S_old)
            if self._kernel_prim:
                q2, qaux2 = K.prim_aux(u_new, L, self.eos, cfg.small_dens, self.small_temp,
                                       ctx.geom.dx, with_divu=False)
            else:
                q2, qaux2 = au.ctoprim(u_new, L, self.eos, cfg.small_dens, self.small_temp)
            src_new = torch.zeros_like(u)
            corr = None
            src_old_generic = src_old
            for fn, term in zip(self.source_fns, src_old_terms):
                if hasattr(fn, "corrector"):
                    cfn = fn.corrector(self, u, u_new, t, dtw, ctx=ctx, fluxes=fluxes)
                    corr = cfn if corr is None else corr + cfn
                    # this source's old-time term leaves the generic pair
                    src_old_generic = src_old_generic - term
                else:
                    src_new = src_new + fn(self, u_new, q2, qaux2, t + dt, dtw, ctx=ctx)
            del src_old_terms
            u_new = u_new + 0.5 * dtw * (src_new - src_old_generic)
            if corr is not None:
                u_new = u_new + dtw * corr
            if c.source_term_predictor == 1:
                # 2/dt x the new-time source term, momentum rows only
                # (Castro.cpp:3815-3818)
                newtime = 0.5 * (src_new - src_old_generic)
                if corr is not None:
                    newtime = newtime + corr
                pred_out = torch.zeros_like(u)
                for comp in (L.UMX, L.UMY, L.UMZ):
                    pred_out[comp] = 2.0 * newtime[comp] / dtw
            u_new = self._clean_fill_impl(u_new, t=t + dt, ctx=ctx)

        self._burn_fail = None
        if self.reactor is not None:
            # the second half-dt burn; a failed burn fails the step
            u_new, _, _, bf2 = self.reactor.react(u_new, 0.5 * dtw,
                                                  u_new[L.USHK] if L.shock_var else None)
            u_new = self._clean_fill_impl(u_new, t=t + dt, ctx=ctx)
            self._burn_fail = ctx.pany(burn_fail | bf2)
            nan_flag = nan_flag | self._burn_fail

        out = (u_new, min_rho, nan_flag)
        if self.keep_fluxes:
            out = out + (self._interior_fluxes(fluxes, u.shape[1:]),)
        del fluxes
        if c.source_term_predictor == 1:
            out = out + (pred_out if pred_out is not None else torch.zeros_like(u),)
        return out

    def _interior_fluxes(self, fluxes, grown):
        """The interior face fluxes of per-direction fluxes on the grown
        grid of shape `grown`: along d the n+1 faces of the interior,
        across it the interior cells."""
        ng, dim = self.ng, self.layout.dim
        fint = []
        for d, f in enumerate(fluxes):
            idx = [slice(None)] + [slice(ng, -ng)] * dim
            idx[1 + d] = slice(ng, grown[d] - ng + 1)
            fint.append(f[tuple(idx)])
        return fint

    def _sdc_step(self, u, dt, t, keep_fluxes=False):
        """One true-SDC step of the ghost-filled state u (sdc/__init__.py):
        (u_new, min_rho, nan_flag, burn_fail) as 0-d tensors, the interior's
        min density and non-finite flag taken after the step's clean + fill
        as the JAX package takes them (`castro_tpu/driver/sim.py:1186-1193`);
        with `keep_fluxes` the interior face fluxes of the step's time
        average follow, for the AMR flux registers
        (`castro_tpu/driver/amr.py:149-173`, `:261-286`)."""
        out = self.sdc.advance(u, dt, t, keep_fluxes=keep_fluxes)
        u_new, fail = out[0], out[1]
        inner = u_new[interior_slice(self.ng, self.layout.dim)]
        res = (u_new, torch.min(inner[self.layout.URHO]), ~torch.isfinite(torch.sum(inner)),
               fail)
        if keep_fluxes:
            res = res + (self._interior_fluxes(out[2], u.shape[1:]),)
        return res

    def _mhd_step_impl(self, u, b, dt, t=0.0, ctx: Optional[StepCtx] = None, keep_ct=False):
        """One driver MHD step (castro_tpu/driver/sim.py:1048-1144; reference
        do_advance_ctu with USE_MHD, Castro_advance_ctu.cpp:16 and
        Castro_mhd.cpp): a half-dt Strang burn, the old-time sources traced
        into the CTU-CT interface states (srcQ), the MHD advance (CTU-CT, or
        RK2 flux-CT with castro.mhd_ctu=0), the old sources added, the
        time-centred corrector (a source's own with the step's gas fluxes),
        the second half burn, the MHD clean. Returns (u_new, b_new, min_rho,
        nan_flag), the checks 0-d tensors taken before the corrector (the
        burn's failure folded into the flag); with keep_ct (AMR, CTU-CT
        only) then the interior gas fluxes (per direction n+1 faces along
        it, the interior across) and the CT data {"E": edge EMFs, "FB":
        cell-B fluxes}, grown: the AMR driver slices the edges itself, as
        it needs their +1 planes."""
        self._reset_sources()
        try:
            return self._mhd_step(u, b, dt, t, ctx, keep_ct)
        finally:
            self._reset_sources()

    def _mhd_step(self, u, b, dt, t, ctx, keep_ct):
        from castro_tpu_torch.mhd.solver import MhdState

        ctx = ctx or self._default_ctx
        L = self.layout
        c = self.params.castro
        dtw = K.wt(dt, self.dtype)
        u = ctx.fill(u, t)
        b = self.mhd.fill_b_all(b)

        burn_fail = torch.zeros((), dtype=torch.bool, device=u.device)
        if self.reactor is not None:
            u, _, _, bf = self.reactor.react(u, 0.5 * dtw, u[L.USHK] if L.shock_var else None)
            burn_fail = burn_fail | bf
            u = self.mhd._clean(u, b, ctx)

        q, qaux = au.ctoprim(u, L, self.eos, self.cfg.small_dens, self.small_temp)
        src_old = None
        src_old_terms = []
        if self.source_fns:
            src_old = torch.zeros_like(u)
            for fn in self.source_fns:
                term = fn(self, u, q, qaux, t, dtw, ctx=ctx)
                src_old_terms.append(term)
                src_old = src_old + term
        srcQ = None if src_old is None else au.src_to_prim(q, qaux, src_old, L)
        del q, qaux

        ct_data = None
        if c.mhd_ctu:
            out = self.mhd.step_ctu(MhdState(u, b), dtw, srcQ=srcQ, keep_fluxes=True,
                                    keep_ct=keep_ct, ctx=ctx)
            (u_new, b_new), fluxes = out[0], out[1]
            if keep_ct:
                ct_data = out[2]
        else:
            if keep_ct:
                raise ValueError("the CT register data of AMR come from the CTU-CT step "
                                 "(castro.mhd_ctu=1)")
            u_new, b_new = self.mhd.step_rk2(MhdState(u, b), dtw, ctx=ctx)
            fluxes = None
        del srcQ
        if src_old is not None:
            u_new = u_new + dtw * src_old

        inner = u_new[interior_slice(self.ng, L.dim)]
        min_rho = ctx.pmin(inner[L.URHO])
        nan_flag = ctx.pany(~torch.isfinite(torch.sum(inner)))
        del inner

        if self.source_fns:
            q2, qaux2 = au.ctoprim(u_new, L, self.eos, self.cfg.small_dens, self.small_temp)
            src_new = torch.zeros_like(u)
            corr = None
            src_old_generic = src_old
            for fn, term in zip(self.source_fns, src_old_terms):
                if hasattr(fn, "corrector"):
                    cfn = fn.corrector(self, u, u_new, t, dtw, ctx=ctx, fluxes=fluxes)
                    corr = cfn if corr is None else corr + cfn
                    src_old_generic = src_old_generic - term
                else:
                    src_new = src_new + fn(self, u_new, q2, qaux2, t + dt, dtw, ctx=ctx)
            u_new = u_new + 0.5 * dtw * (src_new - src_old_generic)
            if corr is not None:
                u_new = u_new + dtw * corr

        if self.reactor is not None:
            u_new, _, _, bf2 = self.reactor.react(u_new, 0.5 * dtw,
                                                  u_new[L.USHK] if L.shock_var else None)
            burn_fail = burn_fail | bf2

        u_new = self.mhd._clean(u_new, b_new, ctx)
        burn_fail = ctx.pany(burn_fail)
        if keep_ct:
            return (u_new, b_new, min_rho, nan_flag | burn_fail,
                    self._interior_fluxes(fluxes, u.shape[1:]), ct_data)
        return u_new, b_new, min_rho, nan_flag | burn_fail

    def _ssdc_step_impl(self, u, dt, t):
        """One simplified-SDC step (castro_tpu/driver/sim.py:1010-1036): the
        CTU advective term with the sources summed into it feeds the
        full-dt coupled burn of SimplifiedSDC, twice; then clean + fill.
        The advective term takes the kernels of the CTU step on the
        default context (in 3D prim_aux, flatten, trace_ppm, ctu_face; in
        1D and 2D cmpflx and trans_cmpflx). Returns (u_new, min_rho,
        nan_flag) as 0-d tensors, the burn's failure folded into the flag,
        the checks taken before the clean."""
        L = self.layout
        cfg = self.cfg
        dtw = K.wt(dt, self.dtype)

        def advective(u_k):
            u_k = self._fill(u_k)
            div_node = None
            if self._kernel_prim:
                q, qaux, div_node = K.prim_aux(u_k, L, self.eos, cfg.small_dens,
                                               self.small_temp, self.geom.dx)[:3]
            else:
                q, qaux = au.ctoprim(u_k, L, self.eos, cfg.small_dens, self.small_temp)
            src = None
            if self.source_fns:
                src = torch.zeros_like(u_k)
                for fn in self.source_fns:
                    src = src + fn(self, u_k, q, qaux, t, dtw)
            srcQ = None if src is None else au.src_to_prim(q, qaux, src, L)
            hsrc = ctu_hydro(u_k, q, qaux, srcQ, dtw, self.geom, L, cfg, div_node=div_node)[0]
            return hsrc if src is None else hsrc + src

        self._reset_sources()
        try:
            u_new, burn_fail = self.sdc_simplified.advance(self._fill(u), dtw, t, advective)
        finally:
            self._reset_sources()
        inner = u_new[interior_slice(self.ng, L.dim)]
        min_rho = torch.min(inner[L.URHO])
        nan_flag = ~torch.isfinite(torch.sum(inner))
        u_new = self._clean_fill_impl(u_new)
        return u_new, min_rho, nan_flag | burn_fail

    # -- radiation -------------------------------------------------------------
    def _rad_split(self):
        """Whether the radiation step is the operator-split one: with
        radiation.hydro_coupling=0, castro.do_hydro=0, or a multigroup run
        without groups (castro_tpu/driver/sim.py:897-909)."""
        return not (self.params.radiation.hydro_coupling and self.params.castro.do_hydro
                    and (self.layout.ngroups == 1 or self.rad.nugroup is not None))

    def _fill_rad(self, Er, ngr=None):
        """Interior Er [ngroups, n...] grown by ngr ghost cells (default the
        hydro ghost width): a periodic wrap or an edge clamp, per the hydro
        BCs."""
        ng = self.ng if ngr is None else ngr
        out = Er
        for d in range(self.layout.dim):
            n = out.shape[1 + d]
            idx = torch.arange(-ng, n + ng, device=Er.device)
            idx = idx % n if self.params.castro.lo_bc[d] == 0 else idx.clamp(0, n - 1)
            out = out.index_select(1 + d, idx)
        return out

    def _rad_lambda_grown(self, u_g, Er_g):
        """The flux limiter lambda [ngroups, grown] from the grown state and
        Er, Purser-filtered with radiation.filter_lambda_T."""
        from castro_tpu_torch.ops.stencil import shifted
        from castro_tpu_torch.radiation.fld import fld_lambda

        L = self.layout
        rho = u_g[L.URHO]
        T = u_g[L.UTEMP]
        lam = []
        for g in range(L.ngroups):
            kr = self.rad.kappa_r(rho, torch.clamp(T, min=1e-10))
            g2 = 0.0
            for d in range(L.dim):
                g2 = g2 + ((shifted(Er_g[g], 1, d) - shifted(Er_g[g], -1, d))
                           / (2 * self.geom.dx[d])) ** 2
            R = torch.sqrt(g2) / torch.clamp(kr * torch.clamp(Er_g[g], min=1e-30), min=1e-30)
            lam.append(fld_lambda(R, self.rad.limiter))
        lam = torch.stack(lam)
        fT = self.params.radiation.filter_lambda_T
        if fT > 0:
            from castro_tpu_torch.radiation.filter import apply_filter

            lam = apply_filter(lam, fT, axes=range(1, lam.dim()))
        return lam

    def _inelastic_sct(self, Er_g, rho, e_new, T_new, dt):
        """Compton exchange between the groups after the implicit multigroup
        update (Radiation::inelastic_scattering, MGFLD.cpp:1655-1685):
        kappa_s = max(kappa_r - kappa_p, 0) at nu_0 (MGFLD.cpp:1554), one
        implicit LLPS85 Kompaneets step, the net radiation gain out of the
        gas internal energy."""
        rp = self.params.radiation
        if not rp.do_inelastic_scattering or self.layout.ngroups <= 1:
            return Er_g, e_new
        from castro_tpu_torch.radiation import compton

        nu0 = float(np.asarray(self.rad.nugroup)[0])
        ks = torch.clamp(self.rad.kappa_r(rho, T_new, nu0) - self.rad.kappa_p(rho, T_new, nu0),
                         min=0.0)
        ks = ks.to(Er_g.dtype).expand(rho.shape)
        Er_g, dEr = compton.apply_inelastic_scattering(Er_g, T_new, ks, dt, self.rad.nugroup,
                                                       self.rad.xnu, self.rad.dlognu)
        return Er_g, e_new - dEr / rho

    def _implicit_rad(self, u_new, Er, dt, t, ctx, rad_bc, rad_rhs_extra, keep_rad_flux):
        """The implicit FLD matter coupling of the advected Er (gray or
        multigroup, then Compton), its energy change added to rho e and
        rho E, then clean + fill. Returns (u_new, Er_new, diffusion fluxes
        or None)."""
        L = self.layout
        inner = interior_slice(self.ng, L.dim)
        ui = u_new[inner]
        rho = ui[L.URHO]
        rhoinv = 1.0 / rho
        e = ui[L.UEINT] * rhoinv
        xn = ui[L.UFS: L.UFS + L.nspec] * rhoinv[None]
        es = self.eos.re(rho=rho, e=e, xn=xn)

        def eos_re(e_k):
            return self.eos.re(rho=rho, e=torch.clamp(e_k, min=1e-300), xn=xn)

        metric = self.rad.geom_metric()
        if Er.dim() > L.dim:
            out = self.rad.multigroup_update(Er, rho, e, es.T, es.cv, dt,
                                             nu_centers=self.rad.nugroup, dnu=self.rad.dnugroup,
                                             eos_re=eos_re, metric=metric, bc_override=rad_bc,
                                             rhs_extra=rad_rhs_extra, keep_flux=keep_rad_flux)
            Er_new, e_new = self._inelastic_sct(out[0], rho, out[1], out[2], dt)
        else:
            out = self.rad.gray_update(Er, rho, e, es.T, es.cv, dt, eos_re=eos_re,
                                       metric=metric, bc_override=rad_bc,
                                       rhs_extra=rad_rhs_extra, keep_flux=keep_rad_flux)
            Er_new, e_new = out[0], out[1]
        de = rho * (e_new - e)
        u_new = u_new.clone()
        u_new[(L.UEINT,) + inner[1:]] = u_new[(L.UEINT,) + inner[1:]] + de
        u_new[(L.UEDEN,) + inner[1:]] = u_new[(L.UEDEN,) + inner[1:]] + de
        u_new = self._clean_fill_impl(u_new, t=t + float(dt), ctx=ctx)
        return u_new, Er_new, (out[3] if keep_rad_flux else None)

    def _rad_step_impl(self, u, Er, dt, t=0.0, ctx: Optional[StepCtx] = None, rad_bc=None,
                       rad_rhs_extra=None, keep_rad_flux=False):
        """One radiation step (reference do_advance_ctu then
        final_radiation_call; castro_tpu/driver/sim.py:880-1008). Returns
        (u_new, Er_new, min_rho, nan_flag), the checks 0-d tensors; with
        `keep_rad_flux` then the radiation register fluxes and the gas
        fluxes (None without keep_fluxes); else with keep_fluxes the gas
        fluxes.

        The characteristic rad-CTU step when `_rad_split()` is false; else
        the hydro step on the radiation layout (or source-only with
        do_hydro=0), an upwind advection of Er with the new velocities on a
        1-ghost view, the problem's radiation source (`rad.rad_source_fn(sim,
        t, dt)`, erg/cm^3/s, into the rhs), and the implicit update. AMR:
        `rad_bc` = the coarse-Er Dirichlet values on the window's faces,
        `rad_rhs_extra` = the deferred-sync rhs."""
        self._reset_sources()
        try:
            if not self._rad_split():
                return self._rad_ctu_step(u, Er, dt, t, ctx, rad_bc, rad_rhs_extra,
                                          keep_rad_flux)
            return self._rad_split_step(u, Er, dt, t, ctx, rad_bc, rad_rhs_extra,
                                        keep_rad_flux)
        finally:
            self._reset_sources()

    def _rad_split_step(self, u, Er, dt, t, ctx, rad_bc, rad_rhs_extra, keep_rad_flux):
        from castro_tpu_torch.ops.stencil import shifted

        L = self.layout
        if L.dim == 3 and self.params.castro.do_hydro:
            raise NotImplementedError(_SPLIT_3D)
        out = self._step(u, dt, t, ctx, None, None)
        u_new, min_rho, bad = out[:3]
        hyd_fluxes = out[3] if self.keep_fluxes else None
        dtw = K.wt(dt, self.dtype)

        # upwind Er advection with the new velocities, on a 1-ghost view
        multigroup = Er.dim() > L.dim
        ng = self.ng
        Er1 = self._fill_rad(Er if multigroup else Er[None], ngr=1)
        if not multigroup:
            Er1 = Er1[0]
        sl1 = tuple(slice(ng - 1, n - ng + 1) for n in u_new.shape[1:])
        rho1 = torch.clamp(u_new[(L.URHO,) + sl1], min=1e-300)
        pre = (slice(None),) if multigroup else ()
        Er_adv = Er
        for d in range(L.dim):
            ax = d + (1 if multigroup else 0)
            vel1 = u_new[(L.momentum_index(d),) + sl1] / rho1
            vf1 = 0.5 * (vel1 + shifted(vel1, -1, d))  # face i-1/2 at i
            if multigroup:
                vf1 = vf1[None]
            # the edge clamp touches only the outermost ghost plane, which
            # the face slices below never read
            F1 = vf1 * torch.where(vf1 > 0, shifted(Er1, -1, ax), Er1)
            lo = [slice(1, -1)] * L.dim
            hi = [slice(1, -1)] * L.dim
            hi[d] = slice(2, None)
            Er_adv = Er_adv - dtw * (F1[pre + tuple(hi)] - F1[pre + tuple(lo)]) / self.geom.dx[d]

        src_fn = getattr(self.rad, "rad_source_fn", None)
        if src_fn is not None:
            q_src = dtw * src_fn(self, t, dtw)
            rad_rhs_extra = q_src if rad_rhs_extra is None else rad_rhs_extra + q_src
        u_new, Er_new, rad_fluxes = self._implicit_rad(u_new, Er_adv, dtw, t, ctx or
                                                       self._default_ctx, rad_bc,
                                                       rad_rhs_extra, keep_rad_flux)
        if keep_rad_flux:
            return u_new, Er_new, min_rho, bad, rad_fluxes, hyd_fluxes
        if self.keep_fluxes:
            return u_new, Er_new, min_rho, bad, hyd_fluxes
        return u_new, Er_new, min_rho, bad

    def _rad_ctu_step(self, u, Er, dt, t, ctx, rad_bc, rad_rhs_extra, keep_rad_flux):
        """The characteristic rad-CTU step of any dimension: radiation in
        the CTU eigensystem (trace_ppm_rad, the RADIATION transverse
        branches, ctu_rad_consup), then the implicit FLD matter coupling
        (castro_tpu/driver/sim.py:738-878). With `keep_rad_flux` the
        radiation register fluxes are the advective fluxes of the chain
        (interior faces, cell-registered) plus the implicit diffusion
        fluxes; the work terms are sources and are not registered."""
        from castro_tpu_torch.ops.rad_hydro import ctu_rad_hydro

        L = self.layout
        c = self.params.castro
        rp = self.params.radiation
        ctx = ctx or self._default_ctx
        dtw = K.wt(dt, self.dtype)
        u = ctx.fill(u, t)
        gray = Er.dim() == L.dim
        Er_int = Er[None] if gray else Er
        Er_g2 = self._fill_rad(Er_int)
        lam_g = self._rad_lambda_grown(u, Er_g2)
        q, qaux = au.ctoprim(u, L, self.eos, self.cfg.small_dens, self.small_temp, Er=Er_g2,
                             lam=lam_g, rad_limiter=self.rad.limiter)
        del Er_g2, lam_g
        src_old = None
        if self.source_fns:
            src_old = torch.zeros_like(u)
            for fn in self.source_fns:
                src_old = src_old + fn(self, u, q, qaux, t, dtw, ctx=ctx)
        srcQ = None if src_old is None else au.src_to_prim(q, qaux, src_old, L)
        want_fluxes = keep_rad_flux or self.keep_fluxes
        out = ctu_rad_hydro(u, Er_int, q, qaux, srcQ, dtw, self.geom, L, self.cfg,
                            self.rad.limiter, rp.closure, nugroup=self.rad.nugroup,
                            dlognu=self.rad.dlognu, fspace_type=rp.fspace_advection_type,
                            comoving=rp.comoving, flatten_pp_threshold=rp.flatten_pp_threshold,
                            keep_fluxes=want_fluxes)
        del q, qaux, srcQ
        u_new, Er_new = out[0], out[1]
        if src_old is not None:
            u_new = u_new + dtw * src_old
        inner = u_new[interior_slice(self.ng, L.dim)]
        min_rho = ctx.pmin(inner[L.URHO])
        nan_flag = ctx.pany(~torch.isfinite(torch.sum(inner)) | ~torch.isfinite(torch.sum(Er_new)))
        del inner
        u_new = self._clean_fill_impl(u_new, t=t + dt, ctx=ctx)
        u_new, Er_new, rad_fluxes = self._implicit_rad(u_new, Er_new[0] if gray else Er_new,
                                                       dtw, t, ctx, rad_bc, rad_rhs_extra,
                                                       keep_rad_flux)
        fint = None
        if want_fluxes:
            gas_fluxes, rfluxes = out[2], out[3]
            if self.keep_fluxes:
                fint = self._interior_fluxes(gas_fluxes, u.shape[1:])
        if keep_rad_flux:
            ng = self.ng
            for d in range(L.dim):
                rf = rfluxes[d][0] if gray else rfluxes[d]
                cax = 0 if gray else 1
                sl = [slice(None)] * cax + [slice(ng, -ng)] * L.dim
                sl[cax + d] = slice(ng, rf.shape[cax + d] - ng)
                rad_fluxes[d] = rad_fluxes[d] + rf[tuple(sl)]
            return u_new, Er_new, min_rho, nan_flag, rad_fluxes, fint
        if self.keep_fluxes:
            return u_new, Er_new, min_rho, nan_flag, fint
        return u_new, Er_new, min_rho, nan_flag

    def _filter_prim(self):
        """Purser-filter the primitives every radiation.filter_prim_int steps
        (Radiation::filter_prim, Radiation.cpp:53-136): rho, u, e and X in
        primitive form, then the conserved state rebuilt, and Er."""
        from castro_tpu_torch.radiation.filter import apply_filter

        L = self.layout
        T_ord = self.params.radiation.filter_prim_T
        inner = interior_slice(self.ng, L.dim)
        ui = self.u[inner]
        rho = ui[L.URHO]
        rhoinv = 1.0 / torch.clamp(rho, min=1e-300)
        vel = [ui[L.momentum_index(d)] * rhoinv for d in range(3)]
        e = ui[L.UEINT] * rhoinv
        xn = ui[L.UFS: L.UFS + L.nspec] * rhoinv[None]
        axes = range(L.dim)
        rho_f = torch.clamp(apply_filter(rho, T_ord, axes=axes), min=self.params.castro.small_dens)
        vel_f = [apply_filter(v, T_ord, axes=axes) for v in vel]
        e_f = torch.clamp(apply_filter(e, T_ord, axes=axes), min=1e-300)
        xn_f = torch.clamp(apply_filter(xn, T_ord, axes=range(1, xn.dim())), 0.0, 1.0)
        xn_f = xn_f / torch.clamp(torch.sum(xn_f, dim=0), min=1e-300)[None]
        es = self.eos.re(rho=rho_f, e=e_f, xn=xn_f)
        ke = 0.5 * rho_f * sum(v * v for v in vel_f)
        u = self.u.clone()
        u[(L.URHO,) + inner[1:]] = rho_f
        for d in range(3):
            u[(L.momentum_index(d),) + inner[1:]] = rho_f * vel_f[d]
        u[(L.UEINT,) + inner[1:]] = rho_f * e_f
        u[(L.UEDEN,) + inner[1:]] = rho_f * e_f + ke
        u[(L.UTEMP,) + inner[1:]] = es.T
        u[(slice(L.UFS, L.UFS + L.nspec),) + inner[1:]] = xn_f * rho_f[None]
        self.u = self._clean_fill_impl(u)
        if self.u_rad is not None:
            ax_er = range(1, self.u_rad.dim()) if self.u_rad.dim() > L.dim else range(L.dim)
            self.u_rad = torch.clamp(apply_filter(self.u_rad, T_ord, axes=ax_er), min=0.0)

    def _pointmass_fix_impl(self, u_old, u_new, point_mass):
        """point_mass_fix_solution=1 (Castro_pointmass.cpp:155): where the
        box of 2 cells about the problem centre gained mass, reset the box to
        the pre-step state and accrete the gain onto the point mass.
        Returns (u, point_mass), the mass as a 0-d tensor."""
        L, g, c = self.layout, self.geom, self.params.castro
        ng = self.ng
        box = []
        for d in range(L.dim):
            lo_sym = c.lo_bc[d] in (3, 4, 5)
            cen = g.prob_lo[d] if lo_sym else 0.5 * (g.prob_lo[d] + g.prob_hi[d])
            icen = int(np.floor((cen - g.prob_lo[d]) / g.dx[d] + 1e-8))
            box.append(slice(ng + max(icen - 2, 0), ng + min(icen + 2, g.n_cell[d])))
        box = tuple(box)
        vol = g.volume(ng).expand(u_new.shape[1:])[box]
        dmass = torch.sum((u_new[(L.URHO,) + box] - u_old[(L.URHO,) + box]) * vol)
        gain = dmass > 0.0
        fixed = u_new.clone()
        fixed[(slice(None),) + box] = u_old[(slice(None),) + box]
        u = torch.where(gain, fixed, u_new)
        return u, point_mass + torch.where(gain, dmass, torch.zeros_like(dmass))

    def try_step(self, dt: float, t: Optional[float] = None):
        """One trial step from time t (default self.t). On success it keeps
        the step's dS/dt for the next (source_term_predictor=1) and applies
        the point-mass fix (point_mass_fix_solution=1)."""
        t = self.t if t is None else t
        if self.mhd is not None:
            # the face fields are kept only on success
            # (castro_tpu/driver/sim.py:1178-1185)
            u_new, b_new, *checks = self._mhd_step_impl(self.u, self.u_b, dt, t)
            min_rho, nan = torch.stack([x.to(torch.float64) for x in checks]).tolist()
            status = StepStatus(min_rho=min_rho, has_nan=bool(nan))
            if status.success:
                self.u_b = b_new
            return u_new, status
        if self.sdc is not None:
            # one host sync for the checks (castro_tpu/driver/sim.py:1186-1193)
            u_new, *checks = self._sdc_step(self.u, dt, t)
            min_rho, nan, fail = torch.stack([x.to(torch.float64) for x in checks]).tolist()
            return u_new, StepStatus(min_rho=min_rho, has_nan=bool(nan), burn_fail=bool(fail))
        if self.sdc_simplified is not None:
            u_new, *checks = self._ssdc_step_impl(self.u, dt, t)
            min_rho, nan = torch.stack([x.to(torch.float64) for x in checks]).tolist()
            return u_new, StepStatus(min_rho=min_rho, has_nan=bool(nan))
        if self.rad is not None:
            u_new, Er_new, *checks = self._rad_step_impl(self.u, self.u_rad, dt, t)[:4]
            min_rho, nan = torch.stack([x.to(torch.float64) for x in checks]).tolist()
            status = StepStatus(min_rho=min_rho, has_nan=bool(nan))
            if status.success:
                self.u_rad = Er_new
            return u_new, status
        stp = self.params.castro.source_term_predictor == 1
        pm = None
        if self._pm_fix:
            pm = torch.tensor(self.point_mass, dtype=self.dtype, device=self.device)
        out = self._step_impl(self.u, dt, t, src_pred=self._src_pred if stp else None,
                              point_mass=pm)
        u_new, min_rho, nan_flag = out[:3]
        # one host sync for the checks (the burn's flag is folded into
        # nan_flag, as the JAX step folds it, and reported on its own)
        checks = [min_rho, nan_flag] + ([self._burn_fail] if self._burn_fail is not None else [])
        vals = torch.stack([x.to(torch.float64) for x in checks]).tolist()
        bf = bool(vals[2]) if len(vals) > 2 else False
        status = StepStatus(min_rho=vals[0], has_nan=bool(vals[1]) and not bf, burn_fail=bf)
        if status.success:
            if stp:
                self._src_pred = out[-1]
            if self._pm_fix:
                u_new, pm = self._pointmass_fix_impl(self.u, u_new, pm)
                self.point_mass = float(pm)
        return u_new, status

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
            u_rad_save = self.u_rad
            u_b_save = self.u_b
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
            self.u_rad = u_rad_save
            self.u_b = u_b_save
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
        """The coarse-timestep loop (main.cpp:118-214); prints STEP lines and
        the zones-per-microsecond figure of merit with `verbose`. Output
        (plotfiles, checkpoints, sums, logs) raises: `check_io_cadence`."""
        a = self.params.amr
        max_step = max_step if max_step is not None else (a.max_step if a.max_step >= 0 else 10 ** 9)
        stop_time = stop_time if stop_time is not None else (a.stop_time if a.stop_time >= 0 else np.inf)
        verbose = self.params.castro.v if verbose is None else verbose
        check_io_cadence(self.params)
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
            fp = self.params.radiation.filter_prim_int
            if self.rad is not None and fp > 0 and self.step_count % fp == 0:
                self._filter_prim()
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
