"""nova: the hot-CNO network of classical nova envelopes (counterpart of
`castro_tpu/network/nova.py`, whose docstring sets out the sources of each
link; reference Microphysics networks/nova, chosen by
`Exec/science/nova/GNUmakefile`).

14 nuclei: H1, He3, He4, C12, C13, N13, N14, N15, O14, O15, O16, O17,
F17, F18, the hot and cold CNO bi-cycle with its beta-limited isotopes;
the pp chain to He3 and He3 + He3, the CF88 proton captures
(`cno_rates`, shared with rprox), four beta+ decays from measured
half-lives, and 3-alpha. Energetics from AME mass excesses less the mean
neutrino energy of each decay, and the thermal neutrino losses."""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.network import screening
from castro_tpu_torch.network.aprox13 import _T9_FLOOR, abar_zbar_moments
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax

_SPECIES = ("H1", "He3", "He4", "C12", "C13", "N13", "N14", "N15",
            "O14", "O15", "O16", "O17", "F17", "F18")
_A = np.array([1, 3, 4, 12, 13, 13, 14, 15, 14, 15, 16, 17, 17, 18], dtype=float)
_Z = np.array([1, 2, 2, 6, 6, 7, 7, 7, 8, 8, 8, 8, 9, 9], dtype=float)
# AME mass excesses Delta = (M - A m_u) c^2 [MeV]
_DM_MEV = np.array([7.28897, 14.93121, 2.42492, 0.0, 3.12501, 5.34516,
                    2.86342, 0.10144, 8.00736, 2.85560, -4.73700,
                    -0.80877, 1.95170, 0.87310])

(IH1, IHE3, IHE4, IC12, IC13, IN13, IN14, IN15, IO14, IO15, IO16, IO17,
 IF17, IF18) = range(14)

_LN2 = math.log(2.0)
# beta+ decay rates [1/s] from measured half-lives
_LAM_N13 = _LN2 / 597.9
_LAM_O14 = _LN2 / 70.62
_LAM_O15 = _LN2 / 122.24
_LAM_F17 = _LN2 / 64.49
# mean neutrino energy a decay [MeV] (O14: the excited-state branch)
_ENU_N13 = 0.706
_ENU_O14 = 0.8
_ENU_O15 = 1.00
_ENU_F17 = 0.97


def cno_rates(T9):
    """The CF88 analytic N_A<sigma v> fits [cm^3/mol/s] of the CNO proton
    captures (Caughlan & Fowler 1988, ADNDT 40, 283), as a dict; shared by
    the nova and rprox networks."""
    T913 = T9 ** (1.0 / 3.0)
    T923 = T913 * T913
    T943 = T9 * T913
    T953 = T9 * T923
    T9m13 = 1.0 / T913
    T9m23 = 1.0 / T923
    T9m32 = 1.0 / (T9 * torch.sqrt(T9))
    exp = torch.exp
    r = {}
    r["c12pg"] = (2.04e7 * T9m23 * exp(-13.690 * T9m13 - (T9 / 1.500) ** 2) *
                  (1.0 + 0.030 * T913 + 1.19 * T923 + 0.254 * T9 + 2.06 * T943 + 1.12 * T953)
                  + 1.08e5 * T9m32 * exp(-4.925 / T9)
                  + 2.15e5 * T9m32 * exp(-18.179 / T9))
    r["c13pg"] = (8.01e7 * T9m23 * exp(-13.717 * T9m13 - (T9 / 2.000) ** 2) *
                  (1.0 + 0.030 * T913 + 0.958 * T923 + 0.204 * T9 + 1.39 * T943 + 0.753 * T953)
                  + 1.21e6 * T9 ** (-0.65) * exp(-5.701 / T9))
    r["n13pg"] = (4.04e7 * T9m23 * exp(-15.202 * T9m13 - (T9 / 1.191) ** 2) *
                  (1.0 + 0.027 * T913 - 0.803 * T923 - 0.154 * T9 + 5.00 * T943 + 2.44 * T953)
                  + 2.43e5 * T9m32 * exp(-6.348 / T9))
    r["n14pg"] = (4.90e7 * T9m23 * exp(-15.228 * T9m13 - (T9 / 3.294) ** 2) *
                  (1.0 + 0.027 * T913 - 0.778 * T923 - 0.149 * T9 + 0.261 * T943 + 0.127 * T953)
                  + 2.37e3 * T9m32 * exp(-3.011 / T9)
                  + 2.19e4 * exp(-12.530 / T9))
    r["n15pa"] = (1.08e12 * T9m23 * exp(-15.251 * T9m13 - (T9 / 0.522) ** 2) *
                  (1.0 + 0.027 * T913 + 2.62 * T923 + 0.501 * T9 + 5.36 * T943 + 2.60 * T953)
                  + 1.19e8 * T9m32 * exp(-3.676 / T9)
                  + 5.41e8 / torch.sqrt(T9) * exp(-8.926 / T9))
    r["n15pg"] = (9.78e8 * T9m23 * exp(-15.251 * T9m13 - (T9 / 0.450) ** 2) *
                  (1.0 + 0.027 * T913 + 0.219 * T923 + 0.042 * T9 + 6.83 * T943 + 3.32 * T953)
                  + 1.11e4 * T9m32 * exp(-3.328 / T9)
                  + 1.49e4 * T9m32 * exp(-4.665 / T9)
                  + 3.80e6 * T9m32 * exp(-11.048 / T9))
    # o16(p,g)f17, the CF88 closed form
    r["o16pg"] = (1.50e8 / (T923 * (1.0 + 2.13 * (1.0 - exp(-0.728 * T923))))
                  * exp(-16.692 * T9m13))
    # o17(p,a)n14 and o17(p,g)f18: the leading terms of the CF88-era fits
    r["o17pa"] = (1.53e7 * T9m23 * exp(-16.712 * T9m13 - (T9 / 0.565) ** 2) *
                  (1.0 + 0.025 * T913 + 5.39 * T923 + 0.940 * T9)
                  + 2.92e6 * T9 * exp(-4.247 / T9))
    r["o17pg"] = (7.97e7 * (T9 / (1.0 + 2.69 * T9)) ** (5.0 / 6.0) * T9m32 *
                  exp(-16.712 * T9m13)
                  + 1.51e8 * T9m23 * exp(-16.712 * T9m13) * 1.0e-2)
    # f18(p,a)o15: a Gamow window at the Utku et al. (1998) magnitude
    T9m = vmax(T9, _T9_FLOOR)
    tau = 4.2487 * (9.0 * 9.0 * (18.0 / 19.0) / T9m) ** (1.0 / 3.0)
    r["f18pa"] = 2.9e11 * (9.0 / ((18.0 / 19.0) * T9m * T9m)) ** (1.0 / 3.0) * exp(-tau)
    return r


class NovaNetwork(Network):
    reactive = True

    def __init__(self):
        # B(A, Z) = Z dm_H + N dm_n - dm(A, Z)
        b_mev = _Z * 7.28897 + (_A - _Z) * 8.07132 - _DM_MEV
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=b_mev * C.MeV2erg * C.N_A / _A)

    def rhs(self, rho, T, xn, e=None):
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, _T9_FLOOR)
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)
        zeta, ye = screening.plasma_moments(Y, _Z)

        def scr(z1, z2):
            return screening.screen_pair(rho, T9, zeta, ye, z1, z2)

        cf = cno_rates(T9)
        ydot = [torch.zeros_like(rho) for _ in range(14)]
        enu = torch.zeros_like(rho)  # MeV a mole, summed over the weak links

        def add(changes, rate):
            for i, w in changes:
                ydot[i] = ydot[i] + w * rate

        Yp = Y[IH1]
        # the pp chain (as aprox19)
        T913 = T9 ** (1.0 / 3.0)
        lam_pp = 4.01e-15 / T913 ** 2 * torch.exp(-3.380 / T913) * (
            1.0 + 0.123 * T913 + 1.09 * T913 * T913 + 0.938 * T9)
        r_pp = 0.5 * rho * Yp * Yp * lam_pp * scr(1.0, 1.0)
        add([(IH1, -3.0), (IHE3, 1.0)], r_pp)
        enu = enu + 0.265 * r_pp
        lam_33 = 6.04e10 / T913 ** 2 * torch.exp(-12.276 / T913) * (
            1.0 + 0.034 * T913 - 0.522 * T913 * T913 - 0.124 * T9 +
            0.353 * T9 ** (4.0 / 3.0) + 0.213 * T9 ** (5.0 / 3.0))
        r_33 = 0.5 * rho * Y[IHE3] * Y[IHE3] * lam_33 * scr(2.0, 2.0)
        add([(IHE3, -2.0), (IHE4, 1.0), (IH1, 2.0)], r_33)

        # proton captures
        caps = [
            ("c12pg", IC12, 6.0, [(IH1, -1.0), (IC12, -1.0), (IN13, 1.0)]),
            ("c13pg", IC13, 6.0, [(IH1, -1.0), (IC13, -1.0), (IN14, 1.0)]),
            ("n13pg", IN13, 7.0, [(IH1, -1.0), (IN13, -1.0), (IO14, 1.0)]),
            ("n14pg", IN14, 7.0, [(IH1, -1.0), (IN14, -1.0), (IO15, 1.0)]),
            ("n15pa", IN15, 7.0, [(IH1, -1.0), (IN15, -1.0), (IC12, 1.0), (IHE4, 1.0)]),
            ("n15pg", IN15, 7.0, [(IH1, -1.0), (IN15, -1.0), (IO16, 1.0)]),
            ("o16pg", IO16, 8.0, [(IH1, -1.0), (IO16, -1.0), (IF17, 1.0)]),
            ("o17pa", IO17, 8.0, [(IH1, -1.0), (IO17, -1.0), (IN14, 1.0), (IHE4, 1.0)]),
            ("o17pg", IO17, 8.0, [(IH1, -1.0), (IO17, -1.0), (IF18, 1.0)]),
            ("f18pa", IF18, 9.0, [(IH1, -1.0), (IF18, -1.0), (IO15, 1.0), (IHE4, 1.0)]),
        ]
        for key, itgt, zt, changes in caps:
            add(changes, rho * Yp * Y[itgt] * cf[key] * scr(1.0, zt))

        # beta+ decays
        for i_from, i_to, lam, e_nu in ((IN13, IC13, _LAM_N13, _ENU_N13),
                                        (IO14, IN14, _LAM_O14, _ENU_O14),
                                        (IO15, IN15, _LAM_O15, _ENU_O15),
                                        (IF17, IO17, _LAM_F17, _ENU_F17)):
            add([(i_from, -1.0), (i_to, 1.0)], lam * Y[i_from])
            enu = enu + e_nu * lam * Y[i_from]

        # 3-alpha (the hottest zones)
        T8 = 10.0 * T9
        q3a = 7.275 * C.MeV2erg * C.N_A
        lam3a = 5.09e11 * 64.0 / (T8 ** 3) * torch.exp(-44.027 / T8) * \
            6.0 / q3a * scr(2.0, 2.0) * scr(2.0, 4.0)
        add([(IHE4, -3.0), (IC12, 1.0)], rho * rho * Y[IHE4] ** 3 / 6.0 * lam3a)

        ydot_arr = torch.stack(ydot)
        xdot = ydot_arr * self.column(self.aion, xn, nd)
        dm = self.column(_DM_MEV * C.MeV2erg * C.N_A, xn, nd)
        edot = -torch.sum(ydot_arr * dm, dim=0) - enu * C.MeV2erg * C.N_A
        abar, zbar = abar_zbar_moments(Y, _Z, 14)
        edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
