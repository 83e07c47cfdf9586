"""subch: the sub-Chandra double-detonation network, 17 species
(counterpart of `castro_tpu/network/subch.py`, whose docstring sets out the
physics; reference Microphysics networks/subch, Shen & Bildsten 2009).

aprox13's chain on the first 13 species (its own screening moments), plus
n14(a,g)f18, f18(a,p)ne21 and the proton-catalysed c12(p,g)n13(a,p)o16
bypass collapsed onto c12(p,g), with N13's steady-state branching between
(a,p) and its beta decay. Species: the aprox13 thirteen, N14, F18, Ne21
and the catalytic H1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.network import screening
from castro_tpu_torch.network.aprox13 import (Aprox13Network, _A as _A13, _B_MEV as _B13,
                                              _T9_FLOOR, _Z as _Z13)
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.network.nova import cno_rates
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax

_SPECIES = ("He4", "C12", "O16", "Ne20", "Mg24", "Si28", "S32", "Ar36",
            "Ca40", "Ti44", "Cr48", "Fe52", "Ni56", "N14", "F18",
            "Ne21", "H1")
_A = np.concatenate([_A13, [14.0, 18.0, 21.0, 1.0]])
_Z = np.concatenate([_Z13, [7.0, 9.0, 10.0, 1.0]])
_B_MEV = np.concatenate([_B13, [104.65998, 137.36933, 167.40596, 0.0]])

IN14, IF18, INE21, IH1 = 13, 14, 15, 16
IHE4, IC12, IO16 = 0, 1, 2


class SubchNetwork(Network):
    reactive = True

    def __init__(self, include_neutrinos=True):
        ebin = _B_MEV * C.MeV2erg * C.N_A / _A
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=ebin)
        self.include_neutrinos = include_neutrinos
        self._a13 = Aprox13Network(include_neutrinos=False)

    def rhs(self, rho, T, xn, e=None):
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, _T9_FLOOR)
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)

        xdot13, _ = self._a13.rhs(rho, T, xn[:13])
        ydot = list(xdot13 / self._a13.column(self._a13.aion, xn, nd))
        ydot += [torch.zeros_like(rho) for _ in range(4)]

        zeta, ye = screening.plasma_moments(Y, _Z)

        def scr(z1, z2):
            return screening.screen_pair(rho, T9, zeta, ye, z1, z2)

        def add(changes, rate):
            for i, w in changes:
                ydot[i] = ydot[i] + w * rate

        T913 = T9 ** (1.0 / 3.0)
        T9m13 = 1.0 / T913
        T9m23 = T9m13 * T9m13
        T9m32 = 1.0 / (T9 * torch.sqrt(T9))

        # n14(a,g)f18, CF88
        lam_n14ag = (7.78e9 * T9m23 * torch.exp(-36.031 * T9m13 - (T9 / 0.881) ** 2)
                     + 2.36e-10 * T9m32 * torch.exp(-2.798 / T9)
                     + 2.03 * T9m32 * torch.exp(-5.054 / T9)
                     + 1.15e4 * T9m23 * torch.exp(-12.310 / T9))
        add([(IN14, -1.0), (IHE4, -1.0), (IF18, 1.0)],
            rho * Y[IHE4] * Y[IN14] * lam_n14ag * scr(2.0, 7.0))

        # f18(a,p)ne21, a Gamow window at the Giesen et al. (1994) scale:
        # the source of the catalytic protons
        ahat = 4.0 * 18.0 / 22.0
        tau = 4.2487 * (4.0 * 81.0 * ahat / T9) ** (1.0 / 3.0)
        lam_f18ap = 7.83e9 * (18.0 / (ahat * T9 * T9)) ** (1.0 / 3.0) * 30.0 * torch.exp(-tau)
        add([(IF18, -1.0), (IHE4, -1.0), (INE21, 1.0), (IH1, 1.0)],
            rho * Y[IHE4] * Y[IF18] * lam_f18ap * scr(2.0, 9.0))

        # c12(p,g)n13(a,p)o16 collapsed onto c12(p,g), N13 in steady state
        # between (a,p) toward O16 and its beta decay
        lam_c12pg = cno_rates(T9)["c12pg"]
        ahat_n = 4.0 * 13.0 / 17.0
        tau_n = 4.2487 * (4.0 * 49.0 * ahat_n / T9) ** (1.0 / 3.0)
        lam_n13ap = 7.83e9 * (14.0 / (ahat_n * T9 * T9)) ** (1.0 / 3.0) * 300.0 * \
            torch.exp(-tau_n)
        dest_ap = rho * Y[IHE4] * lam_n13ap * scr(2.0, 7.0)
        lam_n13_beta = math.log(2.0) / 597.9
        branch = dest_ap / (dest_ap + lam_n13_beta)
        r_byp = rho * Y[IH1] * Y[IC12] * lam_c12pg * scr(1.0, 6.0) * branch
        add([(IC12, -1.0), (IHE4, -1.0), (IO16, 1.0)], r_byp)

        ydot_arr = torch.stack(ydot)
        xdot = ydot_arr * self.column(self.aion, xn, nd)
        bion = self.column(_B_MEV * C.MeV2erg * C.N_A, xn, nd)
        edot = torch.sum(ydot_arr * bion, dim=0)
        if self.include_neutrinos:
            ysum = vmax(torch.sum(Y, dim=0), 1e-300)
            abar = 1.0 / ysum
            zbar = abar * torch.sum(Y * self.column(self.zion, xn, nd), dim=0)
            edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
