"""rad_power_law EOS: gamma-law pressure with a power-law specific heat,
c_v = const_c_v rho^m T^-n (counterpart of `castro_tpu/eos/rad_power_law.py`;
reference Microphysics eos/rad_power_law, the EOS of the radiation test
problems). e = c_v T / (1 - n), the integral of c_v dT for n != 1."""

from __future__ import annotations

import torch

from castro_tpu_torch.eos.base import EosState
from castro_tpu_torch.eos.gamma_law import GammaLawEos


class RadPowerLawEos(GammaLawEos):
    pallas_safe = False

    def __init__(self, gamma=5.0 / 3.0, const_c_v=1.0, c_v_exp_m=0.0, c_v_exp_n=0.0,
                 network=None):
        super().__init__(gamma=gamma, network=network)
        self.const_c_v = float(const_c_v)
        self.m = float(c_v_exp_m)
        self.n = float(c_v_exp_n)

    def _cv(self, rho, T):
        return self.const_c_v * rho ** self.m * T ** (-self.n)

    def _fill_rpl(self, rho, T, xn):
        g = self.gamma
        cv = self._cv(rho, T)
        e = cv * T / (1.0 - self.n)
        p = rho * e * (g - 1.0)
        ones = torch.ones_like(p)
        return EosState(
            rho=rho, T=T, p=p, e=e, h=e + p / rho,
            gam1=torch.full_like(p, g), cs=torch.sqrt(g * p / rho),
            dpdr_e=e * (g - 1.0), dpde=rho * (g - 1.0),
            dpdT=rho * (g - 1.0) * cv, dedT=cv, cv=cv, cp=cv * g,
            mu=ones, abar=ones, zbar=ones,
        )

    def rt(self, rho, T, xn=None) -> EosState:
        return self._fill_rpl(rho, T, xn)

    def re(self, rho, e, xn=None) -> EosState:
        # invert e = const_c_v rho^m T^(1-n) / (1-n)
        T = (e * (1.0 - self.n) / (self.const_c_v * rho ** self.m)) ** (1.0 / (1.0 - self.n))
        return self._fill_rpl(rho, T, xn)

    def rp(self, rho, p, xn=None) -> EosState:
        return self.re(rho, p / (rho * (self.gamma - 1.0)), xn)
