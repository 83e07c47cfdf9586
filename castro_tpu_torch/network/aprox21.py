"""aprox21: aprox19 plus Cr56 and Fe56, letting the electron fraction fall
below the Fe54 floor in silicon burning and pre-collapse conditions
(counterpart of `castro_tpu/network/aprox21.py`, whose docstring sets out
where each added flow comes from; reference Microphysics networks/aprox21).

aprox19's RHS runs on the first 19 species, its screening moments without
Cr56 and Fe56, as in the JAX package; added are fe54 + 2n <-> fe56, the
fe56 double electron capture to cr56 and cr56's beta decay back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.network.aprox19 import (Aprox19Network, IFE54, INEUT, _A as _A19,
                                              _B_MEV as _B19, _DM_MEV as _DM19,
                                              _SPECIES as _S19, _Z as _Z19)
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import clip, vmax

_SPECIES = _S19 + ("Cr56", "Fe56")
_A = np.concatenate([_A19, [56.0, 56.0]])
_Z = np.concatenate([_Z19, [24.0, 26.0]])
# AME total binding energies / mass excesses (MeV)
_B_MEV = np.concatenate([_B19, [488.499, 492.254]])
_DM_MEV = np.concatenate([_DM19, [-55.281, -60.601]])

ICR56 = 19
IFE56 = 20
_LN2 = math.log(2.0)


class Aprox21Network(Network):
    reactive = True

    def __init__(self, include_neutrinos=True):
        ebin = _B_MEV * C.MeV2erg * C.N_A / _A
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=ebin)
        self.include_neutrinos = include_neutrinos
        self._a19 = Aprox19Network(include_neutrinos=False)

    def rhs(self, rho, T, xn, e=None):
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, 1e-3)
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)

        xdot19, edot19 = self._a19.rhs(rho, T, xn[:19], e=e)

        ydot = [torch.zeros_like(rho) for _ in range(21)]
        enu = torch.zeros_like(rho)

        def add(idx_changes, rate):
            for i, w in idx_changes:
                ydot[i] = ydot[i] + w * rate

        # fe54 + 2n <-> fe56 (fe55 in steady state), a thermal s-wave rate
        lam_ng = 1.0e6
        q_2n = float(_B_MEV[IFE56] - _B_MEV[IFE54])
        fwd = rho * rho * Y[INEUT] ** 2 * Y[IFE54] * lam_ng
        rev = (9.8685e9 * T9 ** 1.5) ** 2 * (54.0 / 56.0) ** 1.5 * \
            torch.exp(vmax(-q_2n * 11.6045 / T9, -200.0)) * lam_ng * Y[IFE56]
        add([(INEUT, -2.0), (IFE54, -1.0), (IFE56, 1.0)], fwd - rev)

        # fe56 + 2e- -> cr56 + 2nu, rising steeply with rho Ye and T
        ye = torch.sum(Y * self.column(self.zion, xn, nd), dim=0)
        rho_ye7 = vmax(rho * ye, 1.0) / 1.0e7
        lam_ec = 1.0e-9 * rho_ye7 ** 2 * torch.exp(clip(2.0 * (T9 - 3.0), -50.0, 50.0))
        r_ec = Y[IFE56] * lam_ec
        add([(IFE56, -1.0), (ICR56, 1.0)], r_ec)
        q_ec = float(_DM_MEV[IFE56] - _DM_MEV[ICR56])  # < 0: endothermic
        enu = enu + 0.6 * abs(q_ec) * r_ec

        # cr56 beta- (t1/2 = 5.94 min) back toward fe56
        r_b = Y[ICR56] * (_LN2 / 356.4)
        add([(ICR56, -1.0), (IFE56, 1.0)], r_b)
        enu = enu + 1.0 * r_b

        ydot_arr = torch.stack(ydot)
        xdot_new = ydot_arr * self.column(self.aion, xn, nd)
        dm = self.column(_DM_MEV * C.MeV2erg * C.N_A, xn, nd)
        edot_new = -torch.sum(ydot_arr * dm, dim=0) - enu * C.MeV2erg * C.N_A

        xdot = torch.cat([xdot19, torch.zeros((2,) + tuple(rho.shape), dtype=xdot19.dtype,
                                              device=xdot19.device)], dim=0) + xdot_new
        edot = edot19 + edot_new
        if self.include_neutrinos:
            ysum = vmax(torch.sum(Y, dim=0), 1e-300)
            abar = 1.0 / ysum
            zbar = abar * torch.sum(Y * self.column(self.zion, xn, nd), dim=0)
            edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
