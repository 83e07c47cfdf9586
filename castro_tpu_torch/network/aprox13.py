"""aprox13: 13-isotope alpha-chain network, He4 .. Ni56 (counterpart of
`castro_tpu/network/aprox13.py`, whose docstring sets out where each rate
comes from; reference Microphysics networks/aprox13).

Triple-alpha, the CF88 fits of c12(a,g) (x 1.7), c12+c12, c12+o16,
o16+o16, o16(a,g), ne20(a,g), mg24(a,g); the WFHZ78 fits of the heavy
chain (`rates_heavy.py`); detailed-balance reverses; weak + strong
screening (`screening.py`); the (a,p)(p,g) links Si28..Ni56 in the
compensated net-flow form; thermal neutrino losses (`neutrino.py`).

The RHS is vectorized over zones and works under torch.func transforms
(the burner takes its Jacobian with jacfwd).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.network import screening
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.network.rates_heavy import heavy_ag, link_flow_terms
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax, vmin, clip

_SPECIES = ("He4", "C12", "O16", "Ne20", "Mg24", "Si28", "S32",
            "Ar36", "Ca40", "Ti44", "Cr48", "Fe52", "Ni56")
_A = np.array([4, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56], dtype=float)
_Z = np.array([2, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28], dtype=float)
# total nuclear binding energies (MeV)
_B_MEV = np.array([28.29603, 92.16294, 127.62093, 160.64788, 198.25790,
                   236.53790, 271.78250, 306.72020, 342.05680, 375.47720,
                   411.46900, 447.70800, 483.99500])

# Q-values of k + He4 -> k+1 captures (MeV), from the binding energies
_Q_AG = np.array([_B_MEV[k + 1] - _B_MEV[k] - _B_MEV[0] for k in range(1, 12)])

_T9_FLOOR = 1.0e-3

# intermediate odd-Z nuclei of the (a,p)(p,g) links k -> I -> k+1 for
# k = Si28..Fe52 (chain index 5..11): (name, Z, A, Q_ap, Q_pg) [MeV]
_AP_LINKS = {
    5: ("P31", 15.0, 31.0, -1.916, 8.864),
    6: ("Cl35", 17.0, 35.0, -1.866, 8.505),
    7: ("K39", 19.0, 39.0, -1.287, 8.328),
    8: ("Sc43", 21.0, 43.0, -3.522, 8.649),
    9: ("V47", 23.0, 47.0, -0.410, 8.106),
    10: ("Mn51", 25.0, 51.0, 0.558, 7.380),
    11: ("Co55", 27.0, 55.0, 0.832, 7.165),
}


def _gamow_ag(k, T9):
    """k(a,g)k+1 forward rate of the heavy chain (k = 5..11)."""
    return heavy_ag(k, T9)


def _exp_rate(lograte):
    """exp of a log-space rate, clamped to the float32-safe range."""
    return torch.exp(clip(lograte, -200.0, 85.0))


def _cf88_rates(T9):
    """The CF88 analytic fits (N_A<sigma v>, cm^3/mol/s), as a dict; the
    heavy-ion fusions in log space."""
    T913 = T9 ** (1.0 / 3.0)
    T923 = T913 * T913
    T932 = T9 * torch.sqrt(T9)
    T9m13 = 1.0 / T913
    T9m23 = 1.0 / T923
    T9m32 = 1.0 / T932
    lnT9 = torch.log(T9)

    r = {}

    # c12(a,g)o16: CF88 x 1.7 (Weaver-Woosley/aprox13 normalization)
    t1 = 1.04e8 / (T9 * T9 * (1.0 + 0.0489 * T9m23) ** 2) * \
        torch.exp(-32.120 * T9m13 - (T9 / 3.496) ** 2)
    t2 = 1.76e8 / (T9 * T9 * (1.0 + 0.2654 * T9m23) ** 2) * torch.exp(-32.120 * T9m13)
    t3 = 1.25e3 * T9m32 * torch.exp(-27.499 / T9)
    t4 = 1.43e-2 * T9 ** 5 * torch.exp(-15.541 / T9)
    r["c12ag"] = 1.7 * (t1 + t2 + t3 + t4)

    # c12 + c12 -> ne20 + a (log form)
    T9a = T9 / (1.0 + 0.0396 * T9)
    r["c12c12"] = _exp_rate(
        math.log(4.27e26) + (5.0 / 6.0) * torch.log(T9a) - 1.5 * lnT9
        - 84.165 / T9a ** (1.0 / 3.0) - 2.12e-3 * T9 ** 3)

    # c12 + o16 -> mg24 + a (T9 > 0.5 fit; log form)
    T9b = T9 / (1.0 + 0.055 * T9)
    den_co = torch.exp(-0.18 * T9b * T9b) + 1.06e-3 * torch.exp(
        vmin(2.562 * T9b ** (2.0 / 3.0), 85.0))
    r["c12o16"] = _exp_rate(
        math.log(1.72e31) + (5.0 / 6.0) * torch.log(T9b) - 1.5 * lnT9
        - 106.594 / T9b ** (1.0 / 3.0) - torch.log(den_co))

    # o16 + o16 -> si28 + a (log form)
    r["o16o16"] = _exp_rate(
        math.log(7.10e36) - (2.0 / 3.0) * lnT9
        - 135.93 * T9m13 - 0.629 * T923 - 0.445 * T923 * T923 + 0.0103 * T9 * T9)

    # o16(a,g)ne20
    r["o16ag"] = (9.37e9 * T9m23 * torch.exp(-39.757 * T9m13 - (T9 / 1.586) ** 2)
                  + 62.1 * T9m32 * torch.exp(-10.297 / T9)
                  + 538.0 * T9m32 * torch.exp(-12.226 / T9)
                  + 13.0 * T9 * T9 * torch.exp(-20.093 / T9))

    # ne20(a,g)mg24
    r["ne20ag"] = (4.11e11 * T9m23 * torch.exp(-46.766 * T9m13 - (T9 / 2.219) ** 2) *
                   (1.0 + 0.009 * T913 + 0.882 * T923 + 0.055 * T9 +
                    0.749 * T9 * T913 + 0.119 * T9 * T923)
                   + 5.27e3 * T9m32 * torch.exp(-15.869 / T9)
                   + 6.51e3 * torch.sqrt(T9) * torch.exp(-16.223 / T9))

    # mg24(a,g)si28: CF88 resonant terms
    r["mg24ag"] = (4.78e1 * T9m32 * torch.exp(-13.506 / T9)
                   + 2.38e3 * T9m32 * torch.exp(-15.218 / T9)
                   + 2.47e2 * T932 * torch.exp(-15.147 / T9))
    return r


def triple_alpha(rho, T9, Y_he, Y_c, scr3a):
    """Net rate of 3 He4 <-> C12 (forward r3a minus c12 photodisintegration
    rg3a by detailed balance), the closure aprox13, iso7 and aprox19 share."""
    T8 = 10.0 * T9
    q3a_erg_per_mol = 7.275 * C.MeV2erg * C.N_A
    lam3a_T = 5.09e11 * 64.0 / (T8 ** 3) * torch.exp(-44.027 / T8) * 6.0 / q3a_erg_per_mol
    r3a = rho * rho * Y_he ** 3 / 6.0 * lam3a_T * scr3a
    rg3a = lam3a_T / 6.0 * 2.00e20 * T9 ** 3 * torch.exp(
        vmax(-84.424 / T9, -200.0)) * Y_c
    return r3a - rg3a


def abar_zbar_moments(Y, Z, n):
    """(abar, zbar) from molar abundances for the neutrino losses."""
    ysum = vmax(torch.sum(torch.stack([Y[k] for k in range(n)]), dim=0), 1e-300)
    abar = 1.0 / ysum
    zbar = abar * torch.sum(torch.stack([float(Z[k]) * Y[k] for k in range(n)]), dim=0)
    return abar, zbar


class Aprox13Network(Network):
    reactive = True

    def __init__(self, include_neutrinos=True):
        ebin = _B_MEV * C.MeV2erg * C.N_A / _A  # erg/g binding energy
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=ebin)
        self.include_neutrinos = include_neutrinos

    def _screen(self, rho, T9, moments, z1, z2):
        """Screening enhancement, weak + strong (screening.py)."""
        zeta, ye = moments
        return screening.screen_pair(rho, vmax(T9, _T9_FLOOR), zeta, ye,
                                     float(z1), float(z2))

    def rhs(self, rho, T, xn, e=None):
        """Vectorized dX/dt, de/dt (erg/g/s): molar abundances Y_k = X_k/A_k,
        energy from dY . (N_A B_k)."""
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, _T9_FLOOR)
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)
        moments = screening.plasma_moments(Y, _Z)

        def scr(z1, z2):
            return self._screen(rho, T9, moments, z1, z2)

        cf = _cf88_rates(T9)
        ydot = [torch.zeros_like(rho) for _ in range(13)]

        def add(idx_changes, rate):
            for i, w in idx_changes:
                ydot[i] = ydot[i] + w * rate

        # detailed-balance reverse factor for k(a,g)k+1
        def rev_fac(k):
            q = float(_Q_AG[k - 1])
            afac = float((_A[0] * _A[k] / _A[k + 1]) ** 1.5)
            return 9.8685e9 * T9 ** 1.5 * afac * torch.exp(
                vmax(-q * 11.6045 / T9, -200.0))

        add([(0, -3.0), (1, 1.0)], triple_alpha(rho, T9, Y[0], Y[1], scr(2.0, 2.0) * scr(2.0, 4.0)))

        # heavy-ion fusions
        rcc = 0.5 * rho * Y[1] * Y[1] * cf["c12c12"] * scr(6.0, 6.0)
        add([(1, -2.0), (3, 1.0), (0, 1.0)], rcc)
        rco = rho * Y[1] * Y[2] * cf["c12o16"] * scr(6.0, 8.0)
        add([(1, -1.0), (2, -1.0), (4, 1.0), (0, 1.0)], rco)
        roo = 0.5 * rho * Y[2] * Y[2] * cf["o16o16"] * scr(8.0, 8.0)
        add([(2, -2.0), (5, 1.0), (0, 1.0)], roo)

        # alpha captures k(a,g)k+1 along the chain + photodisintegration,
        # in the factored bracket form
        lam_ag = [cf["c12ag"], cf["o16ag"], cf["ne20ag"], cf["mg24ag"]] + \
            [_gamow_ag(k, T9) for k in range(5, 12)]
        for k in range(1, 12):
            lam = lam_ag[k - 1] * scr(2.0, _Z[k])
            net = lam * (rho * Y[0] * Y[k] - rev_fac(k) * Y[k + 1])
            add([(0, -1.0), (k, -1.0), (k + 1, 1.0)], net)

        # (a,p)(p,g) links Si28..Ni56 in the compensated net-flow form
        for k in range(5, 12):
            _name, zI, aI, q_ap, q_pg = _AP_LINKS[k]
            lam_ap, frac, K = link_flow_terms(k, T9, _A, q_ap, q_pg, aI)
            flow = scr(2.0, _Z[k]) * lam_ap * frac * (rho * Y[0] * Y[k] - K * Y[k + 1])
            add([(0, -1.0), (k, -1.0), (k + 1, 1.0)], flow)

        ydot_arr = torch.stack(ydot)
        xdot = ydot_arr * self.column(self.aion, xn, nd)
        bion = self.column(_B_MEV * C.MeV2erg * C.N_A, xn, nd)
        edot = torch.sum(ydot_arr * bion, dim=0)
        if self.include_neutrinos:
            abar, zbar = abar_zbar_moments(Y, _Z, 13)
            edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
