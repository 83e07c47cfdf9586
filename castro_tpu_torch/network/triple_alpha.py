"""triple_alpha_plus_cago: He4, C12, O16 and inert Fe56 with the 3-alpha
reaction and C12(a,g)O16 (counterpart of `castro_tpu/network/triple_alpha.py`;
reference Microphysics networks/triple_alpha_plus_cago, chosen by
`Exec/reacting_tests/{bubble_convergence,reacting_convergence}/GNUmakefile`).

The rates are aprox13's: the composite 3-alpha fit with its 3-body Saha
reverse, and the CF88 C12(a,g)O16 fit with its 2-body detailed-balance
reverse, both screened (`screening.py`)."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.network import screening
from castro_tpu_torch.network.aprox13 import _T9_FLOOR, _cf88_rates, abar_zbar_moments
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax

_SPECIES = ("He4", "C12", "O16", "Fe56")
_A = np.array([4.0, 12.0, 16.0, 56.0])
_Z = np.array([2.0, 6.0, 8.0, 26.0])
# binding energies [MeV] (the table of aprox13/aprox19)
_B_MEV = np.array([28.29603, 92.16294, 127.62093, 492.25389])
_Q_C12AG = 7.16192  # MeV


class TripleAlphaCagoNetwork(Network):
    reactive = True

    def __init__(self):
        ebin = _B_MEV * C.MeV2erg * C.N_A / _A
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=ebin)

    def rhs(self, rho, T, xn, e=None):
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, _T9_FLOOR)
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)
        zeta, ye = screening.plasma_moments(Y, _Z)

        def scr(z1, z2):
            return screening.screen_pair(rho, vmax(T9, _T9_FLOOR), zeta, ye, z1, z2)

        cf = _cf88_rates(T9)
        ydot = [torch.zeros_like(rho) for _ in range(4)]

        # triple-alpha (as aprox13.rhs)
        scr3a = scr(2.0, 2.0) * scr(2.0, 4.0)
        T8 = 10.0 * T9
        q3a_erg_per_mol = 7.275 * C.MeV2erg * C.N_A
        lam3a_T = 5.09e11 * 64.0 / (T8 ** 3) * torch.exp(-44.027 / T8) * 6.0 / q3a_erg_per_mol
        r3a = rho * rho * Y[0] ** 3 / 6.0 * lam3a_T * scr3a
        rg3a = lam3a_T / 6.0 * 2.00e20 * T9 ** 3 * torch.exp(vmax(-84.424 / T9, -200.0)) * Y[1]
        net3a = r3a - rg3a
        ydot[0] = ydot[0] - 3.0 * net3a
        ydot[1] = ydot[1] + net3a

        # C12(a,g)O16 with its detailed-balance reverse
        lam = cf["c12ag"] * scr(2.0, 6.0)
        afac = float((_A[0] * _A[1] / _A[2]) ** 1.5)
        rev = 9.8685e9 * T9 ** 1.5 * afac * torch.exp(
            vmax(-_Q_C12AG * 11.6045 / T9, -200.0)) * lam * Y[2]
        net_ag = rho * Y[0] * Y[1] * lam - rev
        ydot[0] = ydot[0] - net_ag
        ydot[1] = ydot[1] - net_ag
        ydot[2] = ydot[2] + net_ag

        ydot_a = torch.stack(ydot)
        xdot = ydot_a * self.column(self.aion, xn, nd)
        edot = torch.sum(ydot_a * self.column(_B_MEV * C.MeV2erg * C.N_A, xn, nd), dim=0)
        abar, zbar = abar_zbar_moments(Y, _Z, 4)
        edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
