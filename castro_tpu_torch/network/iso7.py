"""iso7: 7-isotope alpha network, He4 C12 O16 Ne20 Mg24 Si28 Ni56
(counterpart of `castro_tpu/network/iso7.py`; reference Microphysics
networks/iso7, a contraction of approx13 for fast He/C/O/Si burning).

It takes aprox13's CF88 fits, heavy-chain fits, reverses and screening.
The chain runs only to Si28; above it one effective QSE link
si28 + 7 he4 <-> ni56, bottlenecked forward by si28(a,g) and in reverse by
ni56(g,a) from detailed balance on fe52(a,g)ni56. Energy generation is
exact given the abundance changes (binding-energy dot product).
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.network import screening
from castro_tpu_torch.network.aprox13 import (_A as _A13, _B_MEV as _B13, _T9_FLOOR,
                                              _Z as _Z13, _cf88_rates, _gamow_ag,
                                              abar_zbar_moments, triple_alpha)
from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.neutrino import sneut
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax

_SPECIES = ("He4", "C12", "O16", "Ne20", "Mg24", "Si28", "Ni56")
# indices into the aprox13 metadata tables
_MAP13 = np.array([0, 1, 2, 3, 4, 5, 12])
_A = _A13[_MAP13]
_Z = _Z13[_MAP13]
_B_MEV = _B13[_MAP13]

IHE4, IC12, IO16, INE20, IMG24, ISI28, INI56 = range(7)


def _rev_fac(q_mev, a1, a2, a12, T9):
    """Detailed-balance reverse factor for a 2-body capture."""
    afac = float((a1 * a2 / a12) ** 1.5)
    return 9.8685e9 * T9 ** 1.5 * afac * torch.exp(
        vmax(-float(q_mev) * 11.6045 / T9, -200.0))


class Iso7Network(Network):
    reactive = True

    def __init__(self, include_neutrinos=True):
        ebin = _B_MEV * C.MeV2erg * C.N_A / _A
        super().__init__(_SPECIES, aion=_A, zion=_Z, ebin=ebin)
        self.include_neutrinos = include_neutrinos

    def rhs(self, rho, T, xn, e=None):
        nd = xn.dim() - 1
        T9 = vmax(T * 1.0e-9, _T9_FLOOR)
        Y = vmax(xn / self.column(self.aion, xn, nd), 0.0)
        zeta, ye = screening.plasma_moments(Y, _Z)

        def scr(z1, z2):
            return screening.screen_pair(rho, vmax(T9, _T9_FLOOR), zeta, ye,
                                         float(z1), float(z2))

        cf = _cf88_rates(T9)
        ydot = [torch.zeros_like(rho) for _ in range(7)]

        def add(idx_changes, rate):
            for i, w in idx_changes:
                ydot[i] = ydot[i] + w * rate

        add([(IHE4, -3.0), (IC12, 1.0)],
            triple_alpha(rho, T9, Y[IHE4], Y[IC12], scr(2.0, 2.0) * scr(2.0, 4.0)))

        # heavy-ion fusions
        rcc = 0.5 * rho * Y[IC12] * Y[IC12] * cf["c12c12"] * scr(6.0, 6.0)
        add([(IC12, -2.0), (INE20, 1.0), (IHE4, 1.0)], rcc)
        rco = rho * Y[IC12] * Y[IO16] * cf["c12o16"] * scr(6.0, 8.0)
        add([(IC12, -1.0), (IO16, -1.0), (IMG24, 1.0), (IHE4, 1.0)], rco)
        roo = 0.5 * rho * Y[IO16] * Y[IO16] * cf["o16o16"] * scr(8.0, 8.0)
        add([(IO16, -2.0), (ISI28, 1.0), (IHE4, 1.0)], roo)

        # (a,g) chain he4..si28 + reverse photodisintegrations
        chain = [(IC12, IO16, cf["c12ag"]), (IO16, INE20, cf["o16ag"]),
                 (INE20, IMG24, cf["ne20ag"]), (IMG24, ISI28, cf["mg24ag"])]
        for k, kp1, lam0 in chain:
            lam = lam0 * scr(2.0, _Z[k])
            q = _B_MEV[kp1] - _B_MEV[k] - _B_MEV[IHE4]
            fwd = rho * Y[IHE4] * Y[k] * lam
            rev = _rev_fac(q, 4.0, _A[k], _A[kp1], T9) * lam * Y[kp1]
            add([(IHE4, -1.0), (k, -1.0), (kp1, 1.0)], fwd - rev)

        # effective QSE link si28 + 7 he4 <-> ni56
        lam_si = _gamow_ag(5, T9) * scr(2.0, _Z[ISI28])
        r_fwd = rho * Y[IHE4] * Y[ISI28] * lam_si
        lam_fe = _gamow_ag(11, T9)
        q_fe_ni = float(_B13[12] - _B13[11] - _B13[0])
        r_rev = _rev_fac(q_fe_ni, 4.0, 52.0, 56.0, T9) * lam_fe * Y[INI56]
        add([(IHE4, -7.0), (ISI28, -1.0), (INI56, 1.0)], r_fwd - r_rev)

        ydot_arr = torch.stack(ydot)
        xdot = ydot_arr * self.column(self.aion, xn, nd)
        bion = self.column(_B_MEV * C.MeV2erg * C.N_A, xn, nd)
        edot = torch.sum(ydot_arr * bion, dim=0)
        if self.include_neutrinos:
            abar, zbar = abar_zbar_moments(Y, _Z, 7)
            edot = edot - sneut(rho, T, abar, zbar)
        return xdot, edot
