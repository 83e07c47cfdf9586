"""Ideal-gamma-law EOS (reference: Microphysics eos/gamma_law).

p = rho e (gamma-1) = rho k T / (mu m_u); all inversions are analytic.
Counterpart of `castro_tpu/eos/gamma_law.py`, with the same operation order
so that the two agree to round-off. The CUDA kernels evaluate the same
arithmetic in-kernel (`csrc/common.cuh`, `gamma_law_re`), from the numbers
`species_coefficients` gives them.
"""

from __future__ import annotations

from typing import Optional

import torch

from castro_tpu_torch.eos.base import Eos, EosState
from castro_tpu_torch.utils import constants as C


class GammaLawEos(Eos):
    pallas_safe = True

    def __init__(self, gamma: float = 5.0 / 3.0, network=None, assume_neutral: bool = True):
        self.gamma = float(gamma)
        self.network = network
        self.assume_neutral = bool(assume_neutral)

    def species_coefficients(self):
        """Per-species (numerator, A) so that 1/mu = sum_i xn_i * num_i / A_i;
        num_i is 1 for a neutral gas and 1 + Z_i otherwise."""
        a = [float(x) for x in self.network.aion]
        z = [float(x) for x in self.network.zion]
        num = [1.0 if self.assume_neutral else 1.0 + zi for zi in z]
        return num, a

    def mu_from_xn(self, xn: Optional[torch.Tensor]):
        if xn is None or self.network is None:
            return 1.0
        num, a = self.species_coefficients()
        inv_mu = 0.0
        for i in range(len(a)):
            if self.assume_neutral:
                inv_mu = inv_mu + xn[i] / a[i]
            else:
                inv_mu = inv_mu + xn[i] * num[i] / a[i]
        return 1.0 / inv_mu

    def _abar_zbar(self, xn, like):
        if xn is None or self.network is None:
            one = torch.ones_like(like)
            return one, one
        a = [float(x) for x in self.network.aion]
        z = [float(x) for x in self.network.zion]
        inv_abar = 0.0
        zsum = 0.0
        for i in range(len(a)):
            inv_abar = inv_abar + xn[i] / a[i]
            zsum = zsum + xn[i] * z[i] / a[i]
        abar = 1.0 / inv_abar
        return abar, abar * zsum

    # k_B/m_u folded at host double precision (see the JAX module)
    _KB_OVER_MU = float(C.k_B) / float(C.m_u)

    def _fill(self, rho, T, xn):
        g = self.gamma
        mu = self.mu_from_xn(xn)
        cv = self._KB_OVER_MU / (mu * (g - 1.0))
        e = cv * T
        p = rho * e * (g - 1.0)
        h = e + p / rho
        cs = torch.sqrt(g * p / rho)
        abar, zbar = self._abar_zbar(xn, e)
        cv_t = torch.as_tensor(cv, dtype=e.dtype, device=e.device).expand_as(e)
        mu_t = torch.as_tensor(mu, dtype=e.dtype, device=e.device).expand_as(e)
        return EosState(
            rho=rho, T=T, p=p, e=e, h=h,
            gam1=torch.full_like(p, g),
            cs=cs,
            dpdr_e=e * (g - 1.0),
            dpde=rho * (g - 1.0),
            dpdT=rho * cv * (g - 1.0),
            dedT=cv_t, cv=cv_t, cp=cv_t * g, mu=mu_t,
            abar=abar.expand_as(e), zbar=zbar.expand_as(e),
        )

    # -- modes -------------------------------------------------------------
    def rt(self, rho, T, xn=None) -> EosState:
        return self._fill(rho, T, xn)

    def re(self, rho, e, xn=None) -> EosState:
        g = self.gamma
        mu = self.mu_from_xn(xn)
        cv = self._KB_OVER_MU / (mu * (g - 1.0))
        return self._fill(rho, e / cv, xn)

    def rp(self, rho, p, xn=None) -> EosState:
        g = self.gamma
        return self.re(rho, p / (rho * (g - 1.0)), xn)

    def rh(self, rho, h, xn=None) -> EosState:
        return self.re(rho, h / self.gamma, xn)

    def tp(self, T, p, xn=None) -> EosState:
        mu = self.mu_from_xn(xn)
        return self._fill(p * mu * C.m_u / (C.k_B * T), T, xn)

    def ph(self, p, h, xn=None) -> EosState:
        e = h / self.gamma
        return self.re(p / (e * (self.gamma - 1.0)), e, xn)
