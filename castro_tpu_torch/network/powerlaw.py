"""powerlaw: two reacting species and an inert one with a power-law rate
(counterpart of `castro_tpu/network/powerlaw.py`; reference Microphysics
networks/powerlaw).

fuel -> ash with  omega_dot = rho X_fuel rtilde (T/T_ref)^nu  above an
activation temperature f_act*T_ref; energy release q = specific_q_burn.
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.network.base import Network


class PowerLawNetwork(Network):
    reactive = True

    IFUEL, IASH, IINERT = 0, 1, 2

    def __init__(self, rtilde=1.0, nu=4.0, specific_q_burn=10.0, T_burn_ref=1.0,
                 rho_burn_ref=1.0, f_act=1.0):
        super().__init__(("fuel", "ash", "inert"), aion=np.array([2.0, 4.0, 8.0]),
                         zion=np.array([1.0, 2.0, 4.0]))
        self.rtilde = rtilde
        self.nu = nu
        self.specific_q_burn = specific_q_burn
        self.T_burn_ref = T_burn_ref
        self.rho_burn_ref = rho_burn_ref
        self.f_act = f_act

    def rhs(self, rho, T, xn, e=None):
        xfuel = xn[self.IFUEL]
        rate = torch.where(
            T >= self.f_act * self.T_burn_ref,
            self.rtilde * (rho / self.rho_burn_ref) * xfuel * (T / self.T_burn_ref) ** self.nu,
            0.0)
        xdot = torch.stack([-rate, rate, torch.zeros_like(rate)])
        edot = rate * self.specific_q_burn
        return xdot, edot
