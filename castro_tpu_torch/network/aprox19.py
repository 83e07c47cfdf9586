"""aprox19: 19-isotope network with hydrogen burning (pp chain + CNO),
helium burning, the alpha chain to Ni56 and the Fe54 link (counterpart of
`castro_tpu/network/aprox19.py`, whose docstring sets out where each rate
comes from; reference Microphysics networks/aprox19).

Energy generation uses mass excesses (exact for the weak links), minus the
neutrino losses per weak link (0.265 MeV per p+p, 1.71 MeV per CNO cycle,
1.0 MeV per c12->n14 transfer) and the thermal losses (`neutrino.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.network import screening
from castro_tpu_torch.network.aprox13 import (_B_MEV as _B13, _T9_FLOOR, _cf88_rates,
                                              _gamow_ag, abar_zbar_moments, triple_alpha)
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax

_SPECIES = ("H1", "He3", "He4", "C12", "N14", "O16", "Ne20", "Mg24",
            "Si28", "S32", "Ar36", "Ca40", "Ti44", "Cr48", "Fe52",
            "Fe54", "Ni56", "n", "p")

_A = np.array([1, 3, 4, 12, 14, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52,
               54, 56, 1, 1], dtype=float)
_Z = np.array([1, 2, 2, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 26,
               28, 0, 1], dtype=float)
# total binding energies (MeV)
_B_MEV = np.array([0.0, 7.71819, 28.29603, 92.16294, 104.65998,
                   127.62093, 160.64788, 198.25790, 236.53790, 271.78250,
                   306.72020, 342.05680, 375.47720, 411.46900, 447.70800,
                   471.76300, 483.99500, 0.0, 0.0])
# mass excesses (MeV), AME: Delta = (M - A m_u) c^2
_DM_MEV = np.array([7.28897, 14.93121, 2.42492, 0.0, 2.86342, -4.73700,
                    -7.04193, -13.93336, -21.49280, -26.01590, -30.23040,
                    -34.84630, -37.54840, -42.81910, -48.33000, -56.24940,
                    -53.90000, 8.07132, 7.28897])

(IH1, IHE3, IHE4, IC12, IN14, IO16, INE20, IMG24, ISI28, IS32, IAR36,
 ICA40, ITI44, ICR48, IFE52, IFE54, INI56, INEUT, IPROT) = range(19)

# the aprox13 alpha-chain species (he4, c12..ni56) in this table
_CHAIN = [IHE4, IC12, IO16, INE20, IMG24, ISI28, IS32, IAR36, ICA40,
          ITI44, ICR48, IFE52, INI56]


def _rev_fac(q_mev, a1, a2, a12, T9):
    afac = float((a1 * a2 / a12) ** 1.5)
    return 9.8685e9 * T9 ** 1.5 * afac * torch.exp(
        vmax(-float(q_mev) * 11.6045 / T9, -200.0))


def _gamow(z1, z2, a1, a2, T9, s_eff=100.0):
    """Non-resonant Gamow-window capture rate."""
    ahat = a1 * a2 / (a1 + a2)
    tau = 4.2487 * (z1 * z1 * z2 * z2 * ahat / T9) ** (1.0 / 3.0)
    pref = 7.83e9 * (z1 * z2 / (ahat * T9 * T9)) ** (1.0 / 3.0) * s_eff
    return pref * torch.exp(-tau)


class Aprox19Network(Network):
    reactive = True

    def __init__(self, include_neutrinos=True):
        ebin = _B_MEV * C.MeV2erg * C.N_A / _A
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=ebin)
        self.include_neutrinos = include_neutrinos

    def rhs(self, rho, T, xn, e=None):
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, _T9_FLOOR)
        T913 = T9 ** (1.0 / 3.0)
        T9m13 = 1.0 / T913
        T9m23 = T9m13 * T9m13
        T9m32 = 1.0 / (T9 * torch.sqrt(T9))
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)
        zeta, ye = screening.plasma_moments(Y, _Z)

        def scr(z1, z2):
            return screening.screen_pair(rho, vmax(T9, _T9_FLOOR), zeta, ye,
                                         float(z1), float(z2))

        cf = _cf88_rates(T9)
        ydot = [torch.zeros_like(rho) for _ in range(19)]
        enu = torch.zeros_like(rho)  # neutrino losses, MeV/mol/s

        def add(idx_changes, rate):
            for i, w in idx_changes:
                ydot[i] = ydot[i] + w * rate

        # ---- hydrogen burning ----
        # p(p,e+nu)d, d(p,g)he3 instantaneous: 3 H1 -> He3
        lam_pp = 4.01e-15 * T9m23 * torch.exp(-3.380 * T9m13) * (
            1.0 + 0.123 * T913 + 1.09 * T913 * T913 + 0.938 * T9)
        r_pp = 0.5 * rho * Y[IH1] * Y[IH1] * lam_pp * scr(1.0, 1.0)
        add([(IH1, -3.0), (IHE3, 1.0)], r_pp)
        enu = enu + 0.265 * r_pp

        # he3(he3,2p)he4
        lam_33 = 6.04e10 * T9m23 * torch.exp(-12.276 * T9m13) * (
            1.0 + 0.034 * T913 - 0.522 * T913 * T913 - 0.124 * T9 +
            0.353 * T9 ** (4.0 / 3.0) + 0.213 * T9 ** (5.0 / 3.0))
        r_33 = 0.5 * rho * Y[IHE3] * Y[IHE3] * lam_33 * scr(2.0, 2.0)
        add([(IHE3, -2.0), (IHE4, 1.0), (IH1, 2.0)], r_33)

        # CNO cycle at the n14(p,g)o15 bottleneck
        lam_n14pg = (4.90e7 * T9m23 * torch.exp(-15.228 * T9m13 - (T9 / 3.294) ** 2) *
                     (1.0 + 0.027 * T913 - 0.778 * T913 * T913 - 0.149 * T9 +
                      0.261 * T9 ** (4.0 / 3.0) + 0.127 * T9 ** (5.0 / 3.0))
                     + 2.37e3 * T9m32 * torch.exp(-3.011 / T9)
                     + 2.19e4 * torch.exp(-12.530 / T9))
        r_cno = rho * Y[IH1] * Y[IN14] * lam_n14pg * scr(1.0, 7.0)
        add([(IH1, -4.0), (IHE4, 1.0)], r_cno)  # catalytic cycle
        enu = enu + 1.71 * r_cno

        # c12(p,g)n13(b+)c13(p,g)n14 at the c12(p,g) bottleneck
        lam_c12pg = (2.04e7 * T9m23 * torch.exp(-13.690 * T9m13 - (T9 / 1.500) ** 2) *
                     (1.0 + 0.030 * T913 + 1.19 * T913 * T913 + 0.254 * T9 +
                      2.06 * T9 ** (4.0 / 3.0) + 1.12 * T9 ** (5.0 / 3.0))
                     + 1.08e5 * T9m32 * torch.exp(-4.925 / T9)
                     + 2.15e5 * T9m32 * torch.exp(-18.179 / T9))
        r_c12pg = rho * Y[IH1] * Y[IC12] * lam_c12pg * scr(1.0, 6.0)
        add([(IH1, -2.0), (IC12, -1.0), (IN14, 1.0)], r_c12pg)
        enu = enu + 1.0 * r_c12pg

        # ---- helium burning + alpha chain ----
        add([(IHE4, -3.0), (IC12, 1.0)],
            triple_alpha(rho, T9, Y[IHE4], Y[IC12], scr(2.0, 2.0) * scr(2.0, 4.0)))

        rcc = 0.5 * rho * Y[IC12] * Y[IC12] * cf["c12c12"] * scr(6.0, 6.0)
        add([(IC12, -2.0), (INE20, 1.0), (IHE4, 1.0)], rcc)
        rco = rho * Y[IC12] * Y[IO16] * cf["c12o16"] * scr(6.0, 8.0)
        add([(IC12, -1.0), (IO16, -1.0), (IMG24, 1.0), (IHE4, 1.0)], rco)
        roo = 0.5 * rho * Y[IO16] * Y[IO16] * cf["o16o16"] * scr(8.0, 8.0)
        add([(IO16, -2.0), (ISI28, 1.0), (IHE4, 1.0)], roo)

        # n14 + 3/2 he4 -> ne20 (approx19 shortcut through f18/o18)
        lam_n14ag = _gamow(2.0, 7.0, 4.0, 14.0, T9, s_eff=10.0)
        r_nag = rho * Y[IHE4] * Y[IN14] * lam_n14ag * scr(2.0, 7.0)
        add([(IN14, -1.0), (IHE4, -1.5), (INE20, 1.0)], r_nag)

        # (a,g) chain c12..ni56 with detailed-balance reverses
        lam_ag = [cf["c12ag"], cf["o16ag"], cf["ne20ag"], cf["mg24ag"]] + \
            [_gamow_ag(k, T9) for k in range(5, 12)]
        for j in range(1, 12):
            k, kp1 = _CHAIN[j], _CHAIN[j + 1]
            lam = lam_ag[j - 1] * scr(2.0, _Z[k])
            q = float(_B13[j + 1] - _B13[j] - _B13[0])
            fwd = rho * Y[IHE4] * Y[k] * lam
            rev = _rev_fac(q, 4.0, _A[k], _A[kp1], T9) * lam * Y[kp1]
            add([(IHE4, -1.0), (k, -1.0), (kp1, 1.0)], fwd - rev)

        # ---- iron-group Ye link: fe54 + 2p <-> ni56 ----
        lam_fp = _gamow(1.0, 26.0, 1.0, 54.0, T9, s_eff=10.0)
        q_54 = float(_B_MEV[INI56] - _B_MEV[IFE54])  # 2 B_p = 0
        fwd = rho * rho * Y[IPROT] ** 2 * Y[IFE54] * lam_fp * scr(1.0, 26.0)
        rev2 = (9.8685e9 * T9 ** 1.5) ** 2 * (1.0 * 1.0 * 54.0 / 56.0) ** 1.5 * torch.exp(
            vmax(-q_54 * 11.6045 / T9, -200.0))
        rev = rev2 * lam_fp * Y[INI56]
        add([(IPROT, -2.0), (IFE54, -1.0), (INI56, 1.0)], fwd - rev)

        ydot_arr = torch.stack(ydot)
        xdot = ydot_arr * self.column(self.aion, xn, nd)
        # energy from mass excesses, minus the weak links' neutrino losses
        dm = self.column(_DM_MEV * C.MeV2erg * C.N_A, xn, nd)
        edot = -torch.sum(ydot_arr * dm, dim=0) - enu * C.MeV2erg * C.N_A
        if self.include_neutrinos:
            abar, zbar = abar_zbar_moments(Y, _Z, 19)
            edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
