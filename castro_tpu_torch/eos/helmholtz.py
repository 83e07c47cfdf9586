"""Helmholtz-class stellar EOS: ions + radiation + tabulated
electron-positron gas (counterpart of `castro_tpu/eos/helmholtz.py`, with
the same operation order so that the two agree to round-off).

Reference: Microphysics eos/helmholtz (Timmes & Swesty 2000). The electron
table is the port's own file (`eos/helmholtz_table.py`); interpolation is
Catmull-Rom bicubic in (log10 rho Ye, log10 T) with the interpolant's
analytic derivatives for chi_T and c_v. Coulomb corrections follow the
Chabrier & Potekhin (1998) one-component-plasma fit as Timmes & Swesty use
it, disabled pointwise where they would drive p or e negative
(`use_coulomb`, on by default as in Microphysics).

Components:
    p = p_ion + p_rad + p_ele;  p_ion = rho k T N_A / abar
    e = e_ion + e_rad + e_ele;  e_rad = a T^4 / rho, p_rad = a T^4 / 3

Every mode works elementwise on tensors of any shape, and under
`torch.func.vmap` / `jacfwd` (the burner's Jacobian): no data-dependent
Python branch, the table indices are detached, the Newton inversions run a
fixed number of iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.eos import helmholtz_table as htab
from castro_tpu_torch.eos.base import Eos, EosState
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax, clip


def _cr_weights(t):
    """Catmull-Rom cubic weights and derivative weights for fraction t."""
    t2 = t * t
    t3 = t2 * t
    w = (
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    )
    dw = (
        -1.5 * t2 + 2.0 * t - 0.5,
        4.5 * t2 - 5.0 * t,
        -4.5 * t2 + 4.0 * t + 0.5,
        1.5 * t2 - 1.0 * t,
    )
    return w, dw


class _Bicubic:
    """Catmull-Rom bicubic interpolation of 2D tables on one grid, with
    derivatives: the 4 x 4 stencil of every table is gathered at once and
    summed in the JAX package's order (along y, then along x)."""

    def __init__(self, x0, dx, y0, dy, tables):
        self.x0, self.dx = float(x0), float(dx)
        self.y0, self.dy = float(y0), float(dy)
        self.tables_np = np.stack([np.asarray(t, dtype=np.float64) for t in tables])
        self.nt, self.nx, self.ny = self.tables_np.shape
        self._flat = {}

    def _table(self, like):
        key = (like.device, like.dtype)
        t = self._flat.get(key)
        if t is None:
            t = torch.as_tensor(self.tables_np.reshape(-1), dtype=like.dtype,
                                device=like.device)
            offs = [k * self.nx * self.ny + (a - 1) * self.ny + (b - 1)
                    for k in range(self.nt) for a in range(4) for b in range(4)]
            t = (t, torch.tensor(offs, dtype=torch.long, device=like.device))
            self._flat[key] = t
        return t

    def __call__(self, x, y):
        """Returns, for each table, (f, df/dx, df/dy)."""
        flat, offs = self._table(x)
        fx = clip((x - self.x0) / self.dx, 1.0, self.nx - 3.0 - 1e-6)
        fy = clip((y - self.y0) / self.dy, 1.0, self.ny - 3.0 - 1e-6)
        ixf = torch.floor(fx).detach()
        iyf = torch.floor(fy).detach()
        tx = fx - ixf
        ty = fy - iyf
        wx, dwx = _cr_weights(tx)
        wy, dwy = _cr_weights(ty)
        # v[k, a, b] = table_k[ix + a - 1, iy + b - 1] (a flat gather: a 0-d
        # index under vmap would be read on the host)
        base = (ixf.long() * self.ny + iyf.long()).reshape(-1)
        shape = tuple(x.shape)
        v = flat[(offs[:, None] + base[None]).reshape(-1)].reshape(
            (self.nt, 4, 4) + shape)
        out = []
        for k in range(self.nt):
            f = 0.0
            dfx = 0.0
            dfy = 0.0
            for a in range(4):
                row_f = 0.0
                row_dy = 0.0
                for b in range(4):
                    row_f = row_f + wy[b] * v[k, a, b]
                    row_dy = row_dy + dwy[b] * v[k, a, b]
                f = f + wx[a] * row_f
                dfx = dfx + dwx[a] * row_f
                dfy = dfy + wx[a] * row_dy
            out.append((f, dfx / self.dx, dfy / self.dy))
        return out


# Chabrier & Potekhin (1998) OCP fit constants (strong / weak coupling)
_CP_A1, _CP_B1, _CP_C1, _CP_D1, _CP_E1 = (-0.898004, 0.96786, 0.220703, -0.86097, 2.5269)
_CP_A2, _CP_B2, _CP_C2 = 0.29561, 1.9885, 0.288675


def _coulomb_terms(rho, T, abar, zbar):
    """Coulomb p, e and their T/rho derivatives (CP98/helmholtz):
    plasg = zbar^2 e^2 / (kT a_i), a_i the ion-sphere radius."""
    kavo = C.k_B * C.N_A
    ytot = 1.0 / abar
    n_i43 = 4.0 * np.pi / 3.0 * C.N_A * rho * ytot  # (4pi/3) n_i
    lami_inv = n_i43 ** (1.0 / 3.0)  # 1 / a_i
    plasg = zbar * zbar * C.q_e * C.q_e * lami_inv / (C.k_B * T)
    plasg = clip(plasg, 1e-30, 1e30)

    # strong coupling (Gamma >= 1)
    x = plasg ** 0.25
    y = kavo * ytot * T  # N_A k T / abar (erg/g)
    g_s = _CP_A1 * plasg + _CP_B1 * x + _CP_C1 / x + _CP_D1
    gp_s = _CP_A1 * plasg + 0.25 * _CP_B1 * x - 0.25 * _CP_C1 / x  # Gamma g'
    e_s = y * g_s
    p_s = rho * e_s / 3.0
    dedT_s = kavo * ytot * (g_s - gp_s)  # d/dT with Gamma ~ 1/T
    dpdT_s = rho * dedT_s / 3.0
    dpdr_s = e_s / 3.0 + y * gp_s / 9.0  # Gamma ~ rho^{1/3}

    # weak coupling (Gamma < 1)
    x3 = plasg * torch.sqrt(plasg)
    yb = plasg ** _CP_B2
    z_w = _CP_C2 * x3 - _CP_A2 / 3.0 * yb
    zp_w = 1.5 * _CP_C2 * x3 - _CP_B2 * _CP_A2 / 3.0 * yb  # Gamma z'
    pion = rho * kavo * T * ytot
    p_w = -pion * z_w
    e_w = 3.0 * p_w / rho
    dpdT_w = -(pion / T) * (z_w - zp_w)
    dedT_w = 3.0 * dpdT_w / rho
    dpdr_w = p_w / rho - pion * zp_w / (3.0 * rho)

    strong = plasg >= 1.0
    return (torch.where(strong, p_s, p_w), torch.where(strong, e_s, e_w),
            torch.where(strong, dpdT_s, dpdT_w), torch.where(strong, dedT_s, dedT_w),
            torch.where(strong, dpdr_s, dpdr_w))


class HelmholtzEos(Eos):
    def __init__(self, network=None, table=None, use_coulomb=True):
        self.network = network
        self.use_coulomb = bool(use_coulomb)
        t = table if table is not None else htab.build_table()
        dx = t["logd"][1] - t["logd"][0]
        dy = t["logt"][1] - t["logt"][0]
        self._tab = _Bicubic(t["logd"][0], dx, t["logt"][0], dy, (t["logp"], t["loge"]))
        self._logd_lo = float(t["logd"][0])
        self._logt_lo = float(t["logt"][0])
        self._species = {}

    def _species_tables(self, like, ndim):
        key = (like.device, like.dtype, ndim)
        t = self._species.get(key)
        if t is None:
            sh = (-1,) + (1,) * ndim
            t = tuple(torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=like.dtype,
                                      device=like.device).reshape(sh)
                      for a in (self.network.aion, self.network.zion))
            self._species[key] = t
        return t

    def _abar_zbar(self, xn, like):
        if xn is None or self.network is None:
            one = torch.ones_like(like)
            return one, one
        aion, zion = self._species_tables(xn, xn.dim() - 1)
        abar = 1.0 / torch.sum(xn / aion, dim=0)
        zbar = abar * torch.sum(xn * zion / aion, dim=0)
        return abar, zbar

    def rt(self, rho, T, xn=None) -> EosState:
        T = vmax(T, 10.0 ** (self._logt_lo + 0.01))
        abar, zbar = self._abar_zbar(xn, rho)
        ye = zbar / abar

        # ions (ideal)
        kavo = C.k_B * C.N_A
        p_ion = rho * kavo * T / abar
        e_ion = 1.5 * kavo * T / abar
        dpdT_ion = rho * kavo / abar
        dedT_ion = 1.5 * kavo / abar
        dpdr_ion = kavo * T / abar

        # radiation
        p_rad = C.a_rad * T**4 / 3.0
        e_rad = C.a_rad * T**4 / rho
        dpdT_rad = 4.0 * C.a_rad * T**3 / 3.0
        dedT_rad = 4.0 * C.a_rad * T**3 / rho
        dpdr_rad = torch.zeros_like(rho)

        # electrons (table): logs of P_e, E_e(volume) vs log(rho Ye), log T
        ld = torch.log10(vmax(rho * ye, 10.0 ** (self._logd_lo + 0.01)))
        lt = torch.log10(T)
        (lp, dlp_dld, dlp_dlt), (le, dle_dld, dle_dlt) = self._tab(ld, lt)
        p_ele = 10.0**lp
        Evol = 10.0**le
        e_ele = Evol / rho
        # d(log10 f)/d(log10 x) -> df/dx = f * dlf_dlx / x
        dpdT_ele = p_ele * dlp_dlt / T
        dpdr_ele = p_ele * dlp_dld / rho
        dedT_ele = e_ele * dle_dlt / T
        dedr_ele = e_ele * (dle_dld - 1.0) / rho

        p = p_ion + p_rad + p_ele
        e = e_ion + e_rad + e_ele
        dpdT = dpdT_ion + dpdT_rad + dpdT_ele
        dpdr = dpdr_ion + dpdr_rad + dpdr_ele
        cv = dedT_ion + dedT_rad + dedT_ele

        if self.use_coulomb:
            # Coulomb corrections, disabled pointwise where they would
            # drive p or e negative (the helmholtz.f90 guard)
            p_c, e_c, dpdT_c, dedT_c, dpdr_c = _coulomb_terms(rho, T, abar, zbar)
            ok = (p + p_c > 0.0) & (e + e_c > 0.0)
            zero = torch.zeros_like(p)
            p = p + torch.where(ok, p_c, zero)
            e = e + torch.where(ok, e_c, zero)
            dpdT = dpdT + torch.where(ok, dpdT_c, zero)
            dpdr = dpdr + torch.where(ok, dpdr_c, zero)
            cv = cv + torch.where(ok, dedT_c, zero)

        cv = vmax(cv, 1e-30)
        dedr_T = dedr_ele - e_rad / rho

        chi_t = dpdT * T / p
        chi_r = dpdr * rho / p
        gam3m1 = p * chi_t / (rho * T * cv)
        gam1 = clip(chi_r + chi_t * gam3m1, 1.01, 3.0)
        cs = torch.sqrt(gam1 * p / rho)
        cp = cv * gam1 / chi_r

        dpdr_e = dpdr - dpdT * dedr_T / cv  # (dp/drho)|e via chain rule
        return EosState(
            rho=rho, T=T, p=p, e=e, h=e + p / rho, gam1=gam1, cs=cs, dpdr_e=dpdr_e,
            dpde=dpdT / cv, dpdT=dpdT, dedT=cv, cv=cv, cp=cp,
            mu=abar / (1.0 + zbar), abar=abar, zbar=zbar,
        )

    def _invert(self, rho, target, xn, getter, T_guess=None, iters=10):
        """Newton on T for getter(state) = target, a fixed number of
        iterations (lax.fori_loop in JAX), each step clipped to [T/2, 2T]."""
        T = torch.full_like(rho * 1.0, 1e7) if T_guess is None else T_guess
        for _ in range(iters):
            s = self.rt(rho=rho, T=T, xn=xn)
            f, dfdT = getter(s)
            Tn = T - (f - target) / vmax(dfdT, 1e-300)
            T = torch.minimum(torch.maximum(Tn, 0.5 * T), 2.0 * T)
        return self.rt(rho=rho, T=T, xn=xn)

    def re(self, rho, e, xn=None, T_guess=None) -> EosState:
        return self._invert(rho, e, xn, lambda s: (s.e, s.dedT), T_guess, 12)

    def rp(self, rho, p, xn=None, T_guess=None) -> EosState:
        return self._invert(rho, p, xn, lambda s: (s.p, s.dpdT), T_guess, 12)

    def rh(self, rho, h, xn=None) -> EosState:
        return self._invert(rho, h, xn, lambda s: (s.h, s.dedT + s.dpdT / s.rho), None, 12)

    def tp(self, T, p, xn=None) -> EosState:
        """Newton on rho for p(rho, T) = p, 15 iterations."""
        rho = torch.full_like(p * 1.0, 1.0)
        for _ in range(15):
            s = self.rt(rho=rho, T=T, xn=xn)
            rn = rho - (s.p - p) / vmax(s.dpdr_e, 1e-300)
            rho = torch.minimum(torch.maximum(rn, 0.1 * rho), 10.0 * rho)
        return self.rt(rho=rho, T=T, xn=xn)
