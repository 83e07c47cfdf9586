"""Polytropic EOS: p = K rho^gamma (counterpart of
`castro_tpu/eos/polytrope.py`; reference Microphysics eos/polytrope).

Barotropic: every mode takes rho (or finds it from p or h) and ignores
the temperature it is given. e = p / (rho (gamma - 1)), and T follows from
e through the gamma law's c_v, so that the thermal quantities stay
defined. polytrope_type 1 is a non-relativistic degenerate electron gas
(gamma 5/3), 2 a relativistic one (gamma 4/3), each with its K from mu_e."""

from __future__ import annotations

from castro_tpu_torch.eos.base import EosState
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.utils import constants as C


class PolytropeEos(GammaLawEos):
    pallas_safe = False

    def __init__(self, K=1.0, gamma=5.0 / 3.0, mu_e=2.0, polytrope_type=0, network=None):
        if polytrope_type == 1:
            gamma = 5.0 / 3.0
            K = 9.9154e12 / mu_e ** (5.0 / 3.0)
        elif polytrope_type == 2:
            gamma = 4.0 / 3.0
            K = 1.2316e15 / mu_e ** (4.0 / 3.0)
        super().__init__(gamma=gamma, network=network)
        self.K = float(K)

    def _fill_poly(self, rho, xn):
        g = self.gamma
        p = self.K * rho ** g
        e = p / (rho * (g - 1.0))
        mu = self.mu_from_xn(xn)
        cv = (float(C.k_B) / float(C.m_u)) / (mu * (g - 1.0))
        return self._fill(rho, e / cv, xn)

    def rt(self, rho, T, xn=None) -> EosState:
        return self._fill_poly(rho, xn)

    def re(self, rho, e, xn=None) -> EosState:
        return self._fill_poly(rho, xn)

    def rp(self, rho, p, xn=None) -> EosState:
        return self._fill_poly(rho, xn)

    def tp(self, T, p, xn=None) -> EosState:
        return self._fill_poly((p / self.K) ** (1.0 / self.gamma), xn)

    def rh(self, rho, h, xn=None) -> EosState:
        # h = gamma K rho^(gamma - 1) / (gamma - 1), inverted for rho
        g = self.gamma
        return self._fill_poly(((g - 1.0) * h / (g * self.K)) ** (1.0 / (g - 1.0)), xn)
