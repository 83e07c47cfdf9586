"""SDC time integration (counterpart of `castro_tpu/sdc/__init__.py`).

- Simplified SDC (castro.time_integration_method=3): iterate {advective
  update from the reaction-informed state; full-dt burn with the
  piecewise-constant advective forcing inside the integrator} (reference
  `Castro_react.cpp:239-480` + `create_source_corrector`,
  `Castro.cpp:3780-3836`). The advective term is the CTU step's
  (`driver/sim.py:Simulation._ssdc_step_impl`).
- True SDC (time_integration_method=2): sdc_order=2, the Gauss-Lobatto
  trapezoid node update with 2nd-order MOL (`ops/mol.py`); sdc_order=4,
  three Gauss-Lobatto nodes with Simpson quadrature, or with
  castro.sdc_quadrature=1 four Radau IIA nodes, with 4th-order MOL
  (`ops/fourth_order.py`) (reference `Source/sdc/Castro_sdc.cpp`,
  ca_sdc_update_o2_lobatto / o4_lobatto / o4_radau).

Reactive runs couple each node interval through the forced burner
(`integrators/stiff.py:make_burner(with_forcing=True)`), the JAX package's
analog of the reference's sdc_solve Newton iteration. A step of order 2
makes 3 MOL evaluations, of order 4 on Lobatto nodes 13 and on Radau nodes
17; each evaluation is one Riemann solve a direction (order 2) or two
(order 4), which the cmpflx kernel takes on the card for riemann_solver 0
and 2. `keep_fluxes` also returns the time-averaged face fluxes in the
exact flux form of the last sweep, which the AMR flux registers need.
"""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.integrators.stiff import make_burner
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.advection_util import ctoprim
from castro_tpu_torch.ops.mol import mol_hydro


def _forced_burner(sim):
    ip = sim.params.integrator
    return make_burner(sim.network, sim.eos, rtol=max(ip.rtol_spec, ip.rtol_enuc),
                       atol_x=ip.atol_spec, atol_e=ip.atol_enuc, with_forcing=True)


def _no_fail(u):
    return torch.zeros((), dtype=torch.bool, device=u.device)


def _forcing(L, u0, rho0, A):
    """The advective forcing of the burn variables from A [NVAR, ...] about
    the state u0 of density rho0: (xdot_force [nspec, ...], edot_force)."""
    xn0 = u0[L.UFS:L.UFS + L.nspec] / rho0[None]
    e0 = u0[L.UEINT] / rho0
    xf = (A[L.UFS:L.UFS + L.nspec] - xn0 * A[L.URHO][None]) / rho0[None]
    ef = (A[L.UEINT] - e0 * A[L.URHO]) / rho0
    return xn0, e0, xf, ef


def _react_rate(sim, u):
    """R(U): the network's rates as conserved sources (zero without a
    reacting network)."""
    L = sim.layout
    if not sim.network.reactive:
        return torch.zeros_like(u)
    rho = torch.clamp(u[L.URHO], min=sim.cfg.small_dens)
    xn = u[L.UFS:L.UFS + L.nspec] / rho[None]
    e = u[L.UEINT] / rho
    es = sim.eos.re(rho=rho, e=e, xn=xn)
    xdot, edot = sim.network.rhs(rho, es.T, xn, e)
    R = torch.zeros_like(u)
    R[L.UFS:L.UFS + L.nspec] = rho[None] * xdot
    R[L.UEINT] = rho * edot
    R[L.UEDEN] = rho * edot
    return R


class SimplifiedSDC:
    """Full-dt burns with advective forcing, 2 SDC iterations."""

    def __init__(self, sim, n_iters=2):
        self.sim = sim
        self.burner = _forced_burner(sim)
        self.n_iters = n_iters

    def advance(self, u, dt, t, advective_fn):
        """advective_fn(u) -> A(U) [NVAR, grown] (hydro + non-reacting
        sources). Returns (u_new, burn_fail), the flag a 0-d tensor."""
        sim = self.sim
        L = sim.layout
        fail = _no_fail(u)
        u_k = u
        for _ in range(self.n_iters):
            A = advective_fn(u_k)
            rho0 = u[L.URHO]
            rho1 = torch.clamp(rho0 + dt * A[L.URHO], min=sim.cfg.small_dens)
            # the advective forcing in the burn's primitive variables
            xn0, e0, xf, ef = _forcing(L, u, rho0, A)
            xn1, e1, bf = self.burner(rho0, u[L.UTEMP], xn0, e0, dt, xdot_force=xf,
                                      edot_force=ef)
            fail = fail | torch.any(bf)
            # U^{k+1}: the conserved update of rho, momenta and E from A,
            # the species and internal energy from the coupled burn
            u_k = u + dt * A
            u_k[L.URHO] = rho1
            u_k[L.UFS:L.UFS + L.nspec] = rho1[None] * xn1
            de_react = rho1 * e1 - (u[L.UEINT] + dt * A[L.UEINT])
            u_k[L.UEINT] = rho1 * e1
            u_k[L.UEDEN] = u_k[L.UEDEN] + de_react
        return u_k, fail


class TrueSDC4:
    """4th-order true SDC: 3 Gauss-Lobatto nodes {0, 1/2, 1}, Simpson
    quadrature, 4th-order finite-volume MOL advection at the nodes
    (reference `ca_sdc_update_advection_o4_lobatto`, sdc_util.cpp:70-110,
    + fourth_order.cpp), sdc_order iterations (at least 2). Reactive runs
    solve the node reaction coupling with the forced burner."""

    def __init__(self, sim, n_iters=None):
        self.sim = sim
        self.n_iters = n_iters or max(int(sim.params.castro.sdc_order), 2)
        self.burner = _forced_burner(sim) if sim.network.reactive else None

    def _adv(self, u, ctx=None):
        """A(U) and the face fluxes of the node state u."""
        from castro_tpu_torch.ops.fourth_order import mol4_hydro

        sim = self.sim
        u = ctx.fill(u, 0.0) if ctx is not None else sim._fill(u)
        adv, fluxes, _ = mol4_hydro(u, sim.geom, sim.layout, sim.cfg, sim.eos, sim.small_temp)
        return adv, fluxes

    def _node_react(self, u_start, Aeff, dt_m, fail):
        """Implicit reaction coupling over one node interval: burn from
        u_start with the effective advective forcing Aeff."""
        sim = self.sim
        L = sim.layout
        if self.burner is None:
            return u_start + dt_m * Aeff, fail
        rho0 = torch.clamp(u_start[L.URHO], min=sim.cfg.small_dens)
        xn0, e0, xf, ef = _forcing(L, u_start, rho0, Aeff)
        xn1, e1, bf = self.burner(rho0, u_start[L.UTEMP], xn0, e0, dt_m, xdot_force=xf,
                                  edot_force=ef)
        fail = fail | torch.any(bf)
        u1 = u_start + dt_m * Aeff
        rho1 = torch.clamp(u1[L.URHO], min=sim.cfg.small_dens)
        de = rho1 * e1 - u1[L.UEINT]
        u1[L.UFS:L.UFS + L.nspec] = rho1[None] * xn1
        u1[L.UEINT] = rho1 * e1
        u1[L.UEDEN] = u1[L.UEDEN] + de
        return u1, fail

    def advance(self, u, dt, t, keep_fluxes=False, ctx=None):
        """One SDC-4 step (k[m] = node states). Returns (u_new, fail)[,
        fluxes]: with keep_fluxes also the time average of the node face
        fluxes (per dim, grown grid) in the exact flux form of the final
        state, for the AMR flux registers (reference: SDC advances fill the
        same flux MultiFabs as CTU, Castro_advance_sdc.cpp:180-210). `ctx`:
        the step context whose fill the nodes take."""
        sim = self.sim
        dt = K.wt(dt, sim.dtype)
        fail = _no_fail(u)
        hdt = 0.5 * dt

        # every node starts at U^n with its advection term. Reactions are
        # not added to the node function evaluations: the burner of each
        # interval integrates them implicitly (as in TrueSDC2); a run
        # without reactions is the reference's
        # ca_sdc_update_advection_o4_lobatto
        A0, Fu = self._adv(u, ctx)
        k = [u, u, u]
        A_old = [A0, A0, A0]
        F_old = [Fu, Fu, Fu]
        F_m0 = F_m1 = Fu
        F_prev = F_old

        for _ in range(self.n_iters):
            F_prev = F_old
            # node 0 -> 1 (dt/2), Simpson over [0, 1/2]:
            # quad = dt/24 (5 A0 + 8 A1 - A2)
            A_m0, F_m0 = self._adv(k[0], ctx)
            quad01 = dt / 24.0 * (5.0 * A_old[0] + 8.0 * A_old[1] - A_old[2])
            Aeff = (hdt * (A_m0 - A_old[0]) + quad01) / hdt
            k1, fail = self._node_react(k[0], Aeff, hdt, fail)
            k[1] = sim._clean_fill_impl(k1, ctx=ctx)

            # node 1 -> 2: quad = dt/24 (-A0 + 8 A1 + 5 A2)
            A_m1, F_m1 = self._adv(k[1], ctx)
            quad12 = dt / 24.0 * (-A_old[0] + 8.0 * A_old[1] + 5.0 * A_old[2])
            Aeff = (hdt * (A_m1 - A_old[1]) + quad12) / hdt
            k2, fail = self._node_react(k[1], Aeff, hdt, fail)
            k[2] = sim._clean_fill_impl(k2, ctx=ctx)
            del Aeff, k1, k2, quad01, quad12

            A_m2, F_m2 = self._adv(k[2], ctx)
            A_old = [A_m0, A_m1, A_m2]
            F_old = [F_m0, F_m1, F_m2]

        if keep_fluxes:
            # the exact flux form of the final state: the last sweep's Aeff
            # combination (the quadrature of the previous sweep's node
            # fluxes and the sweep's defect terms), so the AMR reflux
            # conserves to round-off though the iteration has not converged
            fluxes = [0.5 * (F_m0[d] - F_prev[0][d]) + 0.5 * (F_m1[d] - F_prev[1][d])
                      + (F_prev[0][d] + 4.0 * F_prev[1][d] + F_prev[2][d]) / 6.0
                      for d in range(sim.layout.dim)]
            return k[2], fail, fluxes
        return k[2], fail


class TrueSDC2:
    """2nd-order Gauss-Lobatto SDC: nodes {t^n, t^{n+1}}, trapezoid
    quadrature, MOL advection, implicit reactions at the second node."""

    def __init__(self, sim, n_iters=2):
        self.sim = sim
        self.n_iters = n_iters
        self.burner = _forced_burner(sim) if sim.network.reactive else None

    def _adv(self, u, ctx=None):
        """A(U) and the face fluxes of the node state u."""
        sim = self.sim
        L = sim.layout
        u = ctx.fill(u, 0.0) if ctx is not None else sim._fill(u)
        q, qaux = ctoprim(u, L, sim.eos, sim.cfg.small_dens, sim.small_temp)
        adv, fluxes, _ = mol_hydro(u, q, qaux, 0.0, sim.geom, L, sim.cfg)
        return adv, fluxes

    def advance(self, u, dt, t, keep_fluxes=False, ctx=None):
        """One SDC-2 step. Returns (u_new, fail)[, fluxes]: with keep_fluxes
        also the trapezoid time average of the node fluxes for the AMR flux
        registers. `ctx`: the step context whose fill the nodes take."""
        sim = self.sim
        L = sim.layout
        dt = K.wt(dt, sim.dtype)
        fail = _no_fail(u)
        A0, F0 = self._adv(u, ctx)
        R0 = _react_rate(sim, u)
        u1 = u + dt * (A0 + R0)  # the provisional state (forward Euler)
        u1 = sim._clean_fill_impl(u1, ctx=ctx)
        F1 = F0
        for _ in range(self.n_iters):
            A1, F1 = self._adv(u1, ctx)
            # the trapezoid node update U^1 = U^0 + dt/2 (A0 + A1) + dt/2 (R0
            # + R1); with reactions the R1 piece is solved implicitly by a
            # burn with the time-averaged advective forcing
            if self.burner is not None:
                Aavg = 0.5 * (A0 + A1)
                rho0 = u[L.URHO]
                xn0, e0, xf, ef = _forcing(L, u, rho0, Aavg)
                xn1, e1, bf = self.burner(rho0, u[L.UTEMP], xn0, e0, dt, xdot_force=xf,
                                          edot_force=ef)
                fail = fail | torch.any(bf)
                u1 = u + dt * Aavg
                rho1 = torch.clamp(u1[L.URHO], min=sim.cfg.small_dens)
                de = rho1 * e1 - u1[L.UEINT]
                u1[L.UFS:L.UFS + L.nspec] = rho1[None] * xn1
                u1[L.UEINT] = rho1 * e1
                u1[L.UEDEN] = u1[L.UEDEN] + de
            else:
                u1 = u + 0.5 * dt * (A0 + A1)
            u1 = sim._clean_fill_impl(u1, ctx=ctx)
        if keep_fluxes:
            fluxes = [0.5 * (F0[d] + F1[d]) for d in range(L.dim)]
            return u1, fail, fluxes
        return u1, fail


class TrueSDC4Radau(TrueSDC4):
    """4th-order true SDC on Radau IIA nodes (castro.sdc_quadrature=1): 4
    time nodes {0, (4-sqrt(6))/10, (4+sqrt(6))/10, 1} with the exact Radau
    quadrature weights of `ca_sdc_update_advection_o4_radau`
    (sdc_util.cpp:113-166). The right-biased nodes give L-stable implicit
    node reactions, the reference's choice for stiff burns."""

    SQ6 = math.sqrt(6.0)
    # node positions c_m in [0, 1]
    NODES = (0.0, (4.0 - SQ6) / 10.0, (4.0 + SQ6) / 10.0, 1.0)
    # quadrature weights: row m gives dt * sum_j W[m][j] * A_{j+1}_old for
    # the integral over [c_m, c_{m+1}] (A_0_old never enters: the Radau
    # property)
    W = (
        ((-35.0 * SQ6 + 440.0) / 1800.0, (-169.0 * SQ6 + 296.0) / 1800.0,
         (-16.0 + 24.0 * SQ6) / 1800.0),
        ((-12.0 + 17.0 * SQ6) / 150.0, (12.0 + 17.0 * SQ6) / 150.0,
         (-4.0 * SQ6) / 150.0),
        ((168.0 - 73.0 * SQ6) / 600.0, (120.0 + 5.0 * SQ6) / 600.0,
         (72.0 + 8.0 * SQ6) / 600.0),
    )

    def advance(self, u, dt, t, keep_fluxes=False, ctx=None):
        sim = self.sim
        dt = K.wt(dt, sim.dtype)
        fail = _no_fail(u)
        c = self.NODES
        A0, Fu = self._adv(u, ctx)
        k = [u, u, u, u]
        A_old = [A0, A0, A0, A0]
        F_old = [Fu, Fu, Fu, Fu]
        F_prev = F_old
        F_used = [Fu, Fu, Fu]

        for _ in range(self.n_iters):
            F_prev = F_old
            a0n, f0n = self._adv(k[0], ctx)
            A_new = [a0n]
            F_new = [f0n]
            F_used = []
            for m in range(3):
                dt_m = (c[m + 1] - c[m]) * dt
                quad = dt * sum(w * A_old[j + 1] for j, w in enumerate(self.W[m]))
                Aeff = (dt_m * (A_new[m] - A_old[m]) + quad) / dt_m
                F_used.append(F_new[m])
                kn, fail = self._node_react(k[m], Aeff, dt_m, fail)
                del Aeff, quad
                k[m + 1] = sim._clean_fill_impl(kn, ctx=ctx)
                a_n, f_n = self._adv(k[m + 1], ctx)
                A_new.append(a_n)
                F_new.append(f_n)
            A_old = A_new
            F_old = F_new

        if keep_fluxes:
            # the exact flux form of the last sweep (the defect terms and
            # the Radau quadrature of the previous sweep's node fluxes), as
            # in the Lobatto variant
            fluxes = []
            for d in range(sim.layout.dim):
                tot = 0.0
                for m in range(3):
                    dt_m = (c[m + 1] - c[m]) * dt
                    tot = tot + dt_m * (F_used[m][d] - F_prev[m][d])
                    tot = tot + dt * sum(w * F_prev[j + 1][d] for j, w in enumerate(self.W[m]))
                fluxes.append(tot / dt)
            return k[3], fail, fluxes
        return k[3], fail
