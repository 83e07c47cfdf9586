"""Flux-limited-diffusion radiation: the gray and multigroup implicit
updates (counterpart of `castro_tpu/radiation/fld.py`).

Reference: the Radiation singleton (`Source/radiation/Radiation.cpp`,
solver flags 5 = gray SGFLD / 6 = MGFLD, `Radiation.H:20-31`), the gray
implicit update `single_group_update` (`SGRadSolver.cpp:20-265`: flux
limiter lambda(R), eta-weighted matter coupling, ABec assembly, iterate),
the multigroup `MGFLD_implicit_update`, and the Levermore-Pomraning
limiter closures (`fluxlimiter.F90`).

The Hypre solves are the matrix-free multigrid of `solvers/multigrid.py`
(torch ops). The outer matter-coupling iteration runs a fixed count,
`radiation.outer_iters`, as the JAX package's `lax.scan` does. Each linear
solve runs V-cycles to its tolerance (1e-10 of max|rhs| in float64, 1e-6
in float32) or its cap (40 gray, 15 a group) and appends its (V-cycles,
residual) to `solve_stats` (and, where `solve_history` is set to a list,
its tolerance and its residual after each V-cycle); the multigroup update
solves its groups as one batch (the multigrid's leading batch axis), each
group with its own stop, frozen once it has converged, as the JAX
package's vmapped while_loop freezes it. Opacities are the reference's power-law models (const_kappa *
rho^m * T^-n * nu^p).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.solvers import multigrid as mg
from castro_tpu_torch.utils import constants as C


def fld_lambda(R, limiter=2):
    """Flux limiter lambda(R), the reference closure family
    (fluxlimiter.F90:31-66 FLDlambda): 0 no limiter (1/3); 1-9
    Levermore-Pomraning approximate (2+R)/(6+3R+R^2); 1x Bruenn 1/(3+R);
    2x Larsen 1/sqrt(9+R^2); 3x Minerbo."""
    if limiter == 0:
        return torch.full_like(R, 1.0 / 3.0)
    if limiter < 10:
        return (2.0 + R) / (6.0 + R * (3.0 + R))
    if limiter < 20:
        return 1.0 / (3.0 + R)
    if limiter < 30:
        return 1.0 / torch.sqrt(9.0 + R * R)
    if limiter < 40:
        return torch.where(R < 1.5, 2.0 / (3.0 + torch.sqrt(9.0 + 12.0 * R * R)),
                           1.0 / (1.0 + R + torch.sqrt(1.0 + 2.0 * R)))
    raise ValueError(f"unknown radiation limiter {limiter}")


def edd_factor(lam, R, closure=3):
    """Eddington factor f(lambda, R) (reference fluxlimiter.F90:68-130
    Edd_factor): 0: lambda; 1: 1/3; 2: 1 - 2 lambda; 3: lambda +
    (lambda R)^2 (LP); 4: 1/3 + 2/3 (lambda R)^2."""
    if closure == 0:
        return lam
    if closure == 1:
        return torch.full_like(lam, 1.0 / 3.0)
    if closure == 2:
        return 1.0 - 2.0 * lam
    if closure == 3:
        return lam + (lam * R) ** 2
    if closure == 4:
        return 1.0 / 3.0 + 2.0 / 3.0 * (lam * R) ** 2
    raise ValueError(f"unknown radiation closure {closure}")


def _face_fluxes(E, bcoefs, dx, nb=0):
    """Face diffusion fluxes F_d = -D (E_i - E_{i-1}) / dx_d of a field
    (after `nb` batch axes), cell-registered (face i-1/2 at i, interior
    faces 1..n-1; face 0 zero)."""
    out = []
    for d in range(E.dim() - nb):
        a = nb + d
        n = E.shape[a]
        grad = (E.narrow(a, 1, n - 1) - E.narrow(a, 0, n - 1)) / dx[d]
        F = torch.zeros_like(E)
        F.narrow(a, 1, n - 1).copy_(-bcoefs[d].narrow(a, 1, n - 1) * grad)
        out.append(F)
    return out


class FLDRadiation:
    def __init__(self, params, geom, layout):
        self.params = params
        self.geom = geom
        self.layout = layout
        rp = params.radiation
        self.ngroups = rp.ngroups if params.castro.do_radiation else 0
        self.limiter = rp.limiter
        self.c = C.c_light * rp.c_light_scale
        self.arad = C.a_rad
        self.outer_iters = rp.outer_iters
        self.solve_stats = []
        self.solve_history = None
        self._metric_built = False
        self._metric_cache = None
        # the frequency groups (RadMultiGroup.cpp), float64 numpy arrays,
        # when the inputs define them; a problem may set its own (RadSphere)
        self.nugroup = self.dnugroup = self.dlognu = self.xnu = None
        if self.ngroups > 1 and rp.lowest_group_hz >= 0.0:
            from castro_tpu_torch.radiation.fspace import group_structure

            gs = group_structure(self.ngroups, rp.lowest_group_hz, rp.highest_group_hz,
                                 rp.group_grow_factor, rp.first_group_width_hz)
            self.nugroup, self.dnugroup = gs["nugroup"], gs["dnugroup"]
            self.dlognu, self.xnu = gs["dlognu"], gs["xnu"]

    def planck_weights(self, T, nu_centers=None, dnu=None):
        """The fraction of aT^4 in each group (normalized Planck weights,
        MGFLD.cpp BGroup integration), computed in float64."""
        T = T.double()
        nu_c = torch.as_tensor(np.asarray(self.nugroup if nu_centers is None else nu_centers,
                                          np.float64), device=T.device)
        dn = torch.as_tensor(np.asarray(self.dnugroup if dnu is None else dnu, np.float64),
                             device=T.device)
        shape_nu = (nu_c.shape[0],) + (1,) * T.dim()
        x = (C.hplanck / C.k_B) * nu_c.reshape(shape_nu) / torch.clamp(T, min=1e-10)
        w = x ** 3 / torch.expm1(torch.clamp(x, 1e-6, 80.0))
        w = w * dn.reshape(shape_nu)
        return w / torch.clamp(torch.sum(w, dim=0), min=1e-300)

    # -- opacities (kappa = const * rho^m * T^-n * nu^p) -------------------
    def kappa_p(self, rho, T, nu=None):
        rp = self.params.radiation
        k = rp.const_kappa_p
        if k < 0:  # the Rosseland mean stands in
            return self.kappa_r(rho, T, nu)
        kp = k * rho ** rp.kappa_p_exp_m * T ** (-rp.kappa_p_exp_n)
        if nu is not None and rp.kappa_p_exp_p != 0.0:
            kp = kp * nu ** rp.kappa_p_exp_p
        return torch.clamp(kp, min=rp.kappa_floor)

    def kappa_r(self, rho, T, nu=None):
        rp = self.params.radiation
        k = rp.const_kappa_r
        if k > 0:
            kr = k * rho ** rp.kappa_r_exp_m * T ** (-rp.kappa_r_exp_n)
            if nu is not None and rp.kappa_r_exp_p != 0.0:
                kr = kr * nu ** rp.kappa_r_exp_p
        else:
            kr = torch.zeros_like(rho * T)
        if rp.const_scattering > 0:
            ks = rp.const_scattering * rho ** rp.scattering_exp_m * T ** (-rp.scattering_exp_n)
            if nu is not None and rp.scattering_exp_p != 0.0:
                ks = ks * nu ** rp.scattering_exp_p
            kr = kr + ks
        return torch.clamp(kr, min=max(rp.kappa_floor, 1e-30))

    def _group_kappas(self, fn, rho, T, nu_c):
        """[ngroups, grid] opacities of the groups at the centres nu_c."""
        shape = torch.broadcast_shapes(rho.shape, T.shape)
        return torch.stack([fn(rho, T, nu_c[g]).expand(shape) for g in range(nu_c.shape[0])])

    # -- the diffusion coefficients (spatial axes after nb batch axes) ------
    @staticmethod
    def _grown1(a, nb=0):
        """Grown by 1 ghost cell with a zero gradient at every face."""
        codes = (mg.NEUMANN,) * (a.dim() - nb)
        return mg.fill_bc(mg._grow(a, nb), codes, codes, nb=nb)

    @staticmethod
    def _inner_across(g, d, nb=0):
        """g without its ghosts across every spatial axis but d."""
        for k in range(nb, g.dim()):
            if k != nb + d:
                g = g.narrow(k, 1, g.shape[k] - 2)
        return g

    def _face_avg_grown(self, g, d, nb=0):
        """Face values (n+1 along d) from a 1-ghost grown array."""
        v = self._inner_across(g, d, nb)
        n = v.shape[nb + d] - 2
        return 0.5 * (v.narrow(nb + d, 0, n + 1) + v.narrow(nb + d, 1, n + 1))

    def _grad_mag_grown(self, Eg, nb=0):
        g2 = 0.0
        for d in range(Eg.dim() - nb):
            v = self._inner_across(Eg, d, nb)
            n = v.shape[nb + d] - 2
            g2 = g2 + ((v.narrow(nb + d, 2, n) - v.narrow(nb + d, 0, n))
                       / (2 * self.geom.dx[d])) ** 2
        return torch.sqrt(g2)

    def diffusion_coeffs(self, Er, rho, T, kr=None, nb=0):
        """Face-registered D = c lambda / kappa_R per direction, and the
        cell lambda; with nb=1 for each group of Er [ngroups, ...] (kr
        then [ngroups, ...] too)."""
        if kr is None:
            kr = self.kappa_r(rho, T)
        Eg = self._grown1(Er, nb)
        R = self._grad_mag_grown(Eg, nb) / torch.clamp(kr * torch.clamp(Er, min=1e-30),
                                                        min=1e-30)
        lam = fld_lambda(R, self.limiter)
        Dg = self._grown1(self.c * lam / kr, nb)
        return [self._face_avg_grown(Dg, d, nb) for d in range(Er.dim() - nb)], lam

    # -- boundary conditions -------------------------------------------------
    def _bc(self):
        """Radiation BCs (Radiation.cpp BC parsing + RadBndry): explicit
        `radiation.lo_bc/hi_bc` codes 101 Dirichlet, 102 Neumann (an inward
        flux when its value is non-zero), 104 Marshak, 105
        Sanchez-Pomraning (as Marshak); without an explicit code, from the
        hydro BC. Returns (codes_lo, codes_hi, spec_lo, spec_hi), a spec
        ("value", v) | ("value_groups", None) | ("flux", F) |
        ("marshak", F_inc) | None."""
        rp = self.params.radiation
        lo, hi, vlo, vhi = [], [], [], []
        for d in range(self.geom.dim):
            for side, rcode, hcode, codes, vals in (
                ("lo", rp.lo_bc[d], self.params.castro.lo_bc[d], lo, vlo),
                ("hi", rp.hi_bc[d], self.params.castro.hi_bc[d], hi, vhi),
            ):
                bcval = (rp.lo_bcval if side == "lo" else rp.hi_bcval)[d]
                if rcode == 101:
                    codes.append("dirichlet")
                    gv = getattr(self, "bc_group_vals_" + side, None)
                    vals.append(("value_groups", None) if gv is not None else ("value", bcval))
                elif rcode == 102:
                    if bcval == 0.0:
                        codes.append("neumann")
                        vals.append(None)
                    else:
                        codes.append("robin")
                        vals.append(("flux", bcval))
                elif rcode in (104, 105):
                    codes.append("robin")
                    vals.append(("marshak", bcval))
                elif hcode == 0:
                    codes.append("periodic")
                    vals.append(None)
                elif hcode in (3, 4, 5):
                    codes.append("neumann")
                    vals.append(None)
                else:
                    flag = (rp.lo_bcflag if side == "lo" else rp.hi_bcflag)[d]
                    codes.append("dirichlet")
                    vals.append(("value", bcval if flag else 0.0))
        return tuple(lo), tuple(hi), vlo, vhi

    def _bc_vals(self, spec_lo, spec_hi, bcoefs, vlo_g=None, vhi_g=None, nb=0):
        """The BC values from the specs and the face diffusion coefficients
        (after `nb` group axes; `vlo_g`, `vhi_g` the groups' Dirichlet
        values, broadcastable). Marshak (vacuum, incident flux F_inc): the
        net outward face flux is c E/2 - 2 F_inc (HABEC bfm = 0.5 beta c,
        bfv = 2 beta), so the ghost is E_g = (1 - h c / (2 D)) E_i + 2 F_inc
        h / D; a fixed inward flux F: E_g = E_i + F h / D."""
        vlo, vhi = [], []
        for d in range(self.geom.dim):
            h = self.geom.dx[d]
            b = bcoefs[d]
            n = b.shape[nb + d] - 1
            for spec, vals, D, gv in ((spec_lo[d], vlo, b.narrow(nb + d, 0, 1), vlo_g),
                                      (spec_hi[d], vhi, b.narrow(nb + d, n, 1), vhi_g)):
                if spec is None:
                    vals.append(None)
                elif spec[0] == "value_groups":
                    vals.append(gv)
                elif spec[0] in ("value", "value_arr"):
                    vals.append(spec[1])
                elif spec[0] == "flux":
                    vals.append((torch.ones_like(D), spec[1] * h / torch.clamp(D, min=1e-300)))
                else:  # marshak
                    Dm = torch.clamp(D, min=1e-300)
                    vals.append((1.0 - h * self.c / (2.0 * Dm), 2.0 * spec[1] * h / Dm))
        return vlo, vhi

    def geom_metric(self):
        """The curvilinear {areas, vol} metric of the diffusion solves (the
        reference RadSolve cellCenteredApplyMetrics), in the geometry's
        dtype; None when Cartesian. 1D spherical/cylindrical and 2D RZ."""
        if self._metric_built:
            return self._metric_cache
        self._metric_built = True
        g = self.geom
        if g.coord == CoordSys.CARTESIAN:
            return None

        def t(a):
            return torch.as_tensor(a, dtype=g.dtype, device=g.device)

        r_f = g.prob_lo[0] + (np.arange(g.n_cell[0] + 1, dtype=np.float64)
                              + (0 if g.ilo is None else g.ilo[0])) * g.dx[0]
        if g.dim == 1:
            if g.coord == CoordSys.SPHERICAL:
                areas = [t(4.0 * math.pi * r_f ** 2)]
                vol = t(4.0 * math.pi / 3.0 * (r_f[1:] ** 3 - r_f[:-1] ** 3))
            else:  # cylindrical, per unit height
                areas = [t(2.0 * math.pi * r_f)]
                vol = t(math.pi * (r_f[1:] ** 2 - r_f[:-1] ** 2))
            self._metric_cache = {"areas": areas, "vol": vol}
        elif g.dim == 2 and g.coord == CoordSys.CYLINDRICAL:
            dz = float(g.dx[1])
            ny = g.n_cell[1]
            r_c = 0.5 * (r_f[1:] + r_f[:-1])
            ar = (2.0 * math.pi * r_f)[:, None] * dz * np.ones((1, ny))
            az = (2.0 * math.pi * r_c * float(g.dx[0]))[:, None] * np.ones((1, ny + 1))
            vol = (math.pi * (r_f[1:] ** 2 - r_f[:-1] ** 2))[:, None] * dz * np.ones((1, ny))
            self._metric_cache = {"areas": [t(ar), t(az)], "vol": t(vol)}
        return self._metric_cache

    def _solve(self, rhs, acoef, bcoefs, dt, bc_lo, bc_hi, bvl, bvh, n_vcycles, metric, nb=0):
        rtol = 1e-10 if rhs.dtype == torch.float64 else 1e-6
        out, _ = mg.solve(rhs, self.geom.dx, acoef=acoef, bcoefs=bcoefs, alpha=1.0, beta=dt,
                          bc_lo=bc_lo, bc_hi=bc_hi, bc_vals_lo=bvl, bc_vals_hi=bvh,
                          n_vcycles=n_vcycles, rtol=rtol, metric=metric,
                          stats=self.solve_stats, nb=nb, history=self.solve_history)
        return out

    @staticmethod
    def _matter_T(eos_re, e_k, e, T_guess, cv):
        """(T, cv) of matter energy e_k: exactly through the EOS, or
        linearized about (e, T_guess)."""
        if eos_re is not None:
            es = eos_re(e_k)
            return torch.clamp(es.T, min=1e-10), torch.clamp(es.cv, min=1e-300)
        return torch.clamp(T_guess + (e_k - e) / cv, min=1e-10), cv

    # -- the implicit updates ------------------------------------------------
    def gray_update(self, Er, rho, e, T_guess, cv, dt, eos_re=None, metric=None,
                    bc_override=None, rhs_extra=None, keep_flux=False):
        """One backward-Euler gray FLD solve with the eta-linearized matter
        coupling (reference single_group_update). Returns (Er', e', T'),
        all interior arrays.

        AMR (Radiation level solves + deferred sync, Radiation.cpp:247-289):
        `bc_override` = (bvl, bvh) Dirichlet Er on the window's faces from
        the coarse level, in place of the domain BCs; `rhs_extra` the
        deferred-sync source added to the rhs; `keep_flux` also returns the
        face diffusion fluxes of the result (cell-registered) for the flux
        registers."""
        cl, a_r = self.c, self.arad
        if bc_override is not None:
            bc_lo = bc_hi = ("dirichlet",) * Er.dim()
            spec_lo = [("value_arr", v) for v in bc_override[0]]
            spec_hi = [("value_arr", v) for v in bc_override[1]]
        else:
            bc_lo, bc_hi, spec_lo, spec_hi = self._bc()
        Er_k, e_k = Er, e
        for _ in range(self.outer_iters):
            T_k, cv_k = self._matter_T(eos_re, e_k, e, T_guess, cv)
            kp = self.kappa_p(rho, T_k)
            bcoefs, _ = self.diffusion_coeffs(Er_k, rho, T_k)
            bvl, bvh = self._bc_vals(spec_lo, spec_hi, bcoefs)
            beta = 4.0 * a_r * T_k ** 3 / (rho * cv_k)
            eta = beta * kp * cl * dt / (1.0 + beta * kp * cl * dt)
            # (1 + (1-eta) kp c dt) Er - dt div(D grad Er) = Er^- + (1-eta)
            # kp c dt S, the emission S = a T_k^4 capped so that a cell
            # emits no more than its internal energy (the same S debits the
            # matter below, so the cap conserves energy exactly)
            acoef = 1.0 + (1.0 - eta) * kp * cl * dt
            fac = (1.0 - eta) * kp * cl * dt
            S_emit = torch.minimum(a_r * T_k ** 4, rho * e / torch.clamp(fac, min=1e-300))
            rhs = Er + fac * S_emit
            if rhs_extra is not None:
                rhs = rhs + rhs_extra
            Er_new = self._solve(rhs, acoef, bcoefs, dt, bc_lo, bc_hi, bvl, bvh, 40, metric)
            # the matter update (internal_energy_update), eta-damped
            de = -dt * kp * cl * (S_emit - Er_new) / rho
            e_new = e + de / (1.0 + beta * kp * cl * dt)
            # positivity: a deficit is drawn from the local radiation field
            e_pos = torch.clamp(e_new, min=1e-300)
            Er_k = torch.clamp(Er_new - rho * (e_pos - e_new), min=0.0)
            e_k = e_pos
        T_f = self._matter_T(eos_re, e_k, e, T_guess, cv)[0]
        if keep_flux:
            bcoefs, _ = self.diffusion_coeffs(Er_k, rho, T_f)
            return Er_k, e_k, T_f, _face_fluxes(Er_k, bcoefs, self.geom.dx)
        return Er_k, e_k, T_f

    def multigroup_update(self, Er_g, rho, e, T_guess, cv, dt, nu_centers, dnu, eos_re=None,
                          metric=None, rhs_extra=None, bc_override=None, keep_flux=False):
        """The MGFLD update (reference MGFLD_implicit_update): the outer
        matter-coupling iteration around one diffusion solve per group.
        Frequency-dependent opacities, per-group Dirichlet values
        (`bc_group_vals_lo/hi`, set by a problem), a problem's
        `emissivity_fn(T, nu, dnu) -> (S_g, dS_g/dT)` and a curvilinear
        metric are taken. Er_g: [ngroups, ...].

        AMR (MGFLDRadSolver.cpp:21-120): `bc_override` = per-dim Dirichlet
        face arrays with a leading group axis; `keep_flux` also returns the
        per-group face fluxes ([ngroups, ...] per direction)."""
        cl, a_r = self.c, self.arad
        ng = Er_g.shape[0]
        dtype, dev = Er_g.dtype, Er_g.device
        dim = Er_g.dim() - 1
        bc_lo, bc_hi, spec_lo, spec_hi = self._bc()
        if bc_override is not None:
            bc_lo = bc_hi = ("dirichlet",) * dim
        shape_nu = (ng,) + (1,) * dim
        # the groups in the working dtype, as the JAX package casts them
        nu_centers = torch.as_tensor(np.asarray(nu_centers, np.float64)).to(dtype).to(dev)
        dnu = torch.as_tensor(np.asarray(dnu, np.float64)).to(dtype).to(dev)
        nu_c = nu_centers.reshape(shape_nu)

        def group_vals(name):
            gv = getattr(self, name, None)
            return None if gv is None else torch.as_tensor(gv).to(dtype).to(dev)

        gv_lo, gv_hi = group_vals("bc_group_vals_lo"), group_vals("bc_group_vals_hi")
        zval = torch.zeros(ng, dtype=dtype, device=dev)
        # the groups' Dirichlet values, one a group, broadcast over a face
        vlo = (gv_lo if gv_lo is not None else zval).reshape(shape_nu)
        vhi = (gv_hi if gv_hi is not None else zval).reshape(shape_nu)

        def emission(T):
            fn = getattr(self, "emissivity_fn", None)
            if fn is not None:
                S_g, dS = fn(T, nu_centers, dnu)
                return S_g.to(dtype), dS.to(dtype)
            x = (C.hplanck / C.k_B) * nu_c / torch.clamp(T, min=1e-10)
            w = x ** 3 / torch.expm1(torch.clamp(x, 1e-6, 80.0))
            w = w * dnu.reshape(shape_nu)
            frac = w / torch.clamp(torch.sum(w, dim=0), min=1e-300)
            return (a_r * T ** 4)[None] * frac, (4.0 * a_r * T ** 3)[None] * frac

        Er_k, e_k = Er_g, e
        for _ in range(self.outer_iters):
            T_k, cv_k = self._matter_T(eos_re, e_k, e, T_guess, cv)
            S_g, dSdT_g = emission(T_k)
            kp_g = self._group_kappas(self.kappa_p, rho, T_k, nu_centers)
            kr_gg = self._group_kappas(self.kappa_r, rho, T_k, nu_centers)
            # the matter-coupling stiffness sum_g kp_g dS_g/dT / (rho cv)
            beta_kp = torch.sum(kp_g * dSdT_g, dim=0) / (rho * cv_k)
            eta = beta_kp * cl * dt / (1.0 + beta_kp * cl * dt)
            acoef_g = 1.0 + (1.0 - eta)[None] * kp_g * cl * dt
            rhs_g = Er_g + (1.0 - eta)[None] * kp_g * cl * dt * S_g
            if rhs_extra is not None:
                rhs_g = rhs_g + rhs_extra
            bcoefs = self.diffusion_coeffs(Er_k, rho, T_k, kr=kr_gg, nb=1)[0]
            if bc_override is not None:
                bvl, bvh = list(bc_override[0]), list(bc_override[1])
            else:
                bvl, bvh = self._bc_vals(spec_lo, spec_hi, bcoefs, vlo_g=vlo, vhi_g=vhi, nb=1)
            Er_new = self._solve(rhs_g, acoef_g, bcoefs, dt, bc_lo, bc_hi, bvl, bvh, 15, metric,
                                 nb=1)
            # no gray acceleration (MGFLD.cpp:441): each group solve is
            # eta-linearized against the matter already, and the outer
            # iteration converges geometrically without it
            de = -dt * cl * torch.sum(kp_g * (S_g - Er_new), dim=0) / rho
            e_k = (e + de / (1.0 + beta_kp * cl * dt)).to(e.dtype)
            Er_k = Er_new.to(dtype)
        T_f = self._matter_T(eos_re, e_k, e, T_guess, cv)[0]
        if keep_flux:
            kr_gf = self._group_kappas(self.kappa_r, rho, T_f, nu_centers)
            bco = self.diffusion_coeffs(Er_k, rho, T_f, kr=kr_gf, nb=1)[0]
            return Er_k, e_k, T_f, _face_fluxes(Er_k, bco, self.geom.dx, nb=1)
        return Er_k, e_k, T_f

    def level_fluxes(self, Er, rho, T):
        """Face diffusion fluxes of a field, cell-registered (face i-1/2 at
        i, interior faces; face 0 zero), gray Er [n...] or multigroup
        [ngroups, n...]: the convention of `keep_flux` (reference
        RadSolve::levelFluxReg)."""
        if Er.dim() == rho.dim():
            kr = self.kappa_r(rho, torch.clamp(T, min=1e-10))
            return _face_fluxes(Er, self.diffusion_coeffs(Er, rho, T, kr=kr)[0], self.geom.dx)
        nu = torch.as_tensor(np.asarray(self.nugroup, np.float64)).to(Er.dtype).to(Er.device)
        kr_g = self._group_kappas(self.kappa_r, rho, T, nu)
        return _face_fluxes(Er, self.diffusion_coeffs(Er, rho, T, kr=kr_g, nb=1)[0],
                            self.geom.dx, nb=1)

    def boundary_fluxes(self, Er, rho, T, bvl, bvh):
        """Diffusion fluxes on the (window) boundary faces given Dirichlet
        face values (bvl, bvh): F = -D (E_first - bc) / (dx/2) at the lo
        face and -D (bc - E_last) / (dx/2) at the hi face. Returns per
        direction (F_lo, F_hi), each one face plane (size 1 along d)."""
        bcoefs, _ = self.diffusion_coeffs(Er, rho, T)
        out = []
        for d in range(Er.dim()):
            n = Er.shape[d]
            h = self.geom.dx[d]
            F_lo = -bcoefs[d].narrow(d, 0, 1) * (Er.narrow(d, 0, 1) - bvl[d]) / (0.5 * h)
            F_hi = -bcoefs[d].narrow(d, n, 1) * (bvh[d] - Er.narrow(d, n - 1, 1)) / (0.5 * h)
            out.append((F_lo, F_hi))
        return out

    def estdt(self, Er, rho, e, cv, T):
        """The radiation dt limit (Radiation::EstTimeStep): the relative
        change of Er through the matter coupling; diffusion is implicit."""
        kp = self.kappa_p(rho, T)
        rate = kp * self.c * torch.abs(self.arad * T ** 4 - Er)
        return 0.5 * torch.min(torch.maximum(Er, rho * e) / torch.clamp(rate, min=1e-300))
