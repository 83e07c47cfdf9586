"""rprox: the 10-isotope approximate rp-process network of mixed H/He X-ray
bursts (counterpart of `castro_tpu/network/rprox.py`, whose docstring sets
out each effective link and its bottleneck; reference Microphysics
networks/rprox, chosen by `Exec/science/xrb_mixed/GNUmakefile`; the scheme
of Wallace & Woosley 1981, ApJS 45, 389).

Nuclei: C12, O14, O15, O16, F17, Mg22, S30, Ni56, He4, H1. Helium burning
(3-alpha, C12(a,g)), the beta-limited hot CNO cycle, O16 <-> F17 with its
detailed balance, the breakout links and the WW81 effective upper chain to
Ni56. The CF88 fits come from `nova.cno_rates` and `aprox13._cf88_rates`;
the chain links are Gamow-window forms (`rprox_rates`). Energetics from
AME mass excesses less the neutrino losses of the weak links."""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.network import screening
from castro_tpu_torch.network.aprox13 import _T9_FLOOR, _cf88_rates, abar_zbar_moments
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.network.nova import cno_rates
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax

_SPECIES = ("C12", "O14", "O15", "O16", "F17", "Mg22", "S30", "Ni56", "He4", "H1")
_A = np.array([12, 14, 15, 16, 17, 22, 30, 56, 4, 1], dtype=float)
_Z = np.array([6, 8, 8, 8, 9, 12, 16, 28, 2, 1], dtype=float)
# AME mass excesses [MeV]
_DM_MEV = np.array([0.0, 8.00736, 2.85560, -4.73700, 1.95170, -0.39700,
                    -14.06300, -53.90000, 2.42492, 7.28897])

(IC12, IO14, IO15, IO16, IF17, IMG22, IS30, INI56, IHE4, IH1) = range(10)

_LN2 = math.log(2.0)
_LAM_O14 = _LN2 / 70.62
_LAM_O15 = _LN2 / 122.24
_LAM_F17 = _LN2 / 64.49
# mean neutrino energy a beta+ [MeV]: equipartition of <Q_e+>
_ENU_O14 = 0.5 * (8.00736 - 2.86342 - 1.022)
_ENU_O15 = 0.5 * (2.85560 - 0.10144 - 1.022)
_ENU_F17 = 0.5 * (1.95170 + 0.80877 - 1.022)


def _gamow(z1, z2, a1, a2, T9, s_eff):
    ahat = a1 * a2 / (a1 + a2)
    tau = 4.2487 * (z1 * z1 * z2 * z2 * ahat / T9) ** (1.0 / 3.0)
    pref = 7.83e9 * (z1 * z2 / (ahat * T9 * T9)) ** (1.0 / 3.0) * s_eff
    return pref * torch.exp(-tau)


def rprox_rates(T9):
    """The rprox-specific charged-particle links, as a dict."""
    T913 = T9 ** (1.0 / 3.0)
    T923 = T913 * T913
    T943 = T9 * T913
    T953 = T9 * T923
    T9m13 = 1.0 / T913
    T9m23 = 1.0 / T923
    T9m32 = 1.0 / (T9 * torch.sqrt(T9))
    r = {}
    # o14(a,p)f17: CF88 non-resonant and resonance terms
    r["o14ap"] = (1.68e13 * T9m23 * torch.exp(-39.388 * T9m13 - (T9 / 0.717) ** 2) *
                  (1.0 + 0.011 * T913 + 13.117 * T923 + 0.971 * T9 + 85.295 * T943
                   + 16.061 * T953)
                  + 3.31e4 * T9m32 * torch.exp(-11.733 / T9)
                  + 1.79e7 * T9m32 * torch.exp(-22.609 / T9))
    r["o15ag"] = _gamow(2.0, 8.0, 4.0, 15.0, T9, s_eff=3.0)
    r["f17pg"] = _gamow(1.0, 9.0, 1.0, 17.0, T9, s_eff=50.0)
    # the WW81 chain bottlenecks: the slowest (a,p) on the waiting point
    r["mg22_chain"] = _gamow(2.0, 12.0, 4.0, 22.0, T9, s_eff=30.0)
    r["s30_chain"] = _gamow(2.0, 16.0, 4.0, 30.0, T9, s_eff=30.0)
    return r


class RproxNetwork(Network):
    reactive = True

    def __init__(self):
        b_mev = _Z * 7.28897 + (_A - _Z) * 8.07132 - _DM_MEV
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=b_mev * C.MeV2erg * C.N_A / _A)

    def rhs(self, rho, T, xn, e=None):
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, _T9_FLOOR)
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)
        zeta, ye = screening.plasma_moments(Y, _Z)

        def scr(z1, z2):
            return screening.screen_pair(rho, T9, zeta, ye, z1, z2)

        cno = cno_rates(T9)
        cf = _cf88_rates(T9)
        rp = rprox_rates(T9)
        ydot = [torch.zeros_like(rho) for _ in range(10)]
        enu = torch.zeros_like(rho)

        def add(changes, rate):
            for i, w in changes:
                ydot[i] = ydot[i] + w * rate

        Yp, Ya = Y[IH1], Y[IHE4]

        # helium burning
        T8 = 10.0 * T9
        q3a = 7.275 * C.MeV2erg * C.N_A
        lam3a = 5.09e11 * 64.0 / (T8 ** 3) * torch.exp(-44.027 / T8) * \
            6.0 / q3a * scr(2.0, 2.0) * scr(2.0, 4.0)
        add([(IHE4, -3.0), (IC12, 1.0)], rho * rho * Ya ** 3 / 6.0 * lam3a)
        add([(IHE4, -1.0), (IC12, -1.0), (IO16, 1.0)],
            rho * Ya * Y[IC12] * cf["c12ag"] * scr(2.0, 6.0))

        # hot CNO (beta-limited)
        add([(IH1, -2.0), (IC12, -1.0), (IO14, 1.0)],
            rho * Yp * Y[IC12] * cno["c12pg"] * scr(1.0, 6.0))
        r_o14b = _LAM_O14 * Y[IO14]
        add([(IO14, -1.0), (IH1, -1.0), (IO15, 1.0)], r_o14b)
        enu = enu + _ENU_O14 * r_o14b
        r_o15b = _LAM_O15 * Y[IO15]
        add([(IO15, -1.0), (IH1, -1.0), (IC12, 1.0), (IHE4, 1.0)], r_o15b)
        enu = enu + _ENU_O15 * r_o15b

        # o16 <-> f17: detailed balance with the spin factor g_p g_O16 /
        # g_F17 = 1/3 (F17's ground state is 5/2+)
        lam_opg = cno["o16pg"] * scr(1.0, 8.0)
        fwd = rho * Yp * Y[IO16] * lam_opg
        q_f17 = 0.600  # proton separation energy of F17 [MeV]
        rev = (1.0 / 3.0) * 9.8685e9 * T9 ** 1.5 * (16.0 / 17.0) ** 1.5 * \
            torch.exp(vmax(-q_f17 * 11.6045 / T9, -200.0)) * lam_opg * Y[IF17]
        add([(IH1, -1.0), (IO16, -1.0), (IF17, 1.0)], fwd - rev)

        # breakout
        add([(IO14, -1.0), (IHE4, -1.0), (IH1, 1.0), (IF17, 1.0)],
            rho * Ya * Y[IO14] * rp["o14ap"] * scr(2.0, 8.0))
        r_f17pg = rho * Yp * Y[IF17] * rp["f17pg"] * scr(1.0, 9.0)
        add([(IF17, -1.0), (IH1, -2.0), (IO15, 1.0), (IHE4, 1.0)], r_f17pg)
        enu = enu + 0.5 * r_f17pg  # the ne18 beta of the collapsed chain
        r_f17b = _LAM_F17 * Y[IF17]
        add([(IF17, -1.0), (IH1, -2.0), (IO15, 1.0), (IHE4, 1.0)], r_f17b)
        enu = enu + _ENU_F17 * r_f17b
        r_brk = rho * Ya * Y[IO15] * rp["o15ag"] * scr(2.0, 8.0)
        add([(IO15, -1.0), (IHE4, -1.0), (IH1, -3.0), (IMG22, 1.0)], r_brk)
        enu = enu + 1.0 * r_brk

        # the upper chain to ni56: mg22 + 2a -> s30 balances Z (no beta+);
        # s30 + 6a + 2p -> ni56 takes two beta+, ~1 MeV of neutrinos each
        r1 = rho * Ya * Y[IMG22] * rp["mg22_chain"] * scr(2.0, 12.0)
        add([(IMG22, -1.0), (IHE4, -2.0), (IS30, 1.0)], r1)
        r2 = rho * Ya * Y[IS30] * rp["s30_chain"] * scr(2.0, 16.0)
        add([(IS30, -1.0), (IHE4, -6.0), (IH1, -2.0), (INI56, 1.0)], r2)
        enu = enu + 2.0 * r2

        ydot_arr = torch.stack(ydot)
        xdot = ydot_arr * self.column(self.aion, xn, nd)
        dm = self.column(_DM_MEV * C.MeV2erg * C.N_A, xn, nd)
        edot = -torch.sum(ydot_arr * dm, dim=0) - enu * C.MeV2erg * C.N_A
        abar, zbar = abar_zbar_moments(Y, _Z, 10)
        edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
