"""Multigamma EOS: an ideal gas whose species each have their own gamma
(counterpart of `castro_tpu/eos/multigamma.py`; reference Microphysics
eos/multigamma). The mixture's gamma is the c_v-weighted one:
gamma_eff = 1 + R_mix / c_v with R_mix = sum X_k k/(A_k m_u) and
c_v = sum X_k k/(A_k m_u (gamma_k - 1)). Without a composition it is the
gamma law at the mean of the species' gammas."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.eos.base import EosState
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.utils import constants as C


class MultigammaEos(GammaLawEos):
    pallas_safe = False  # the kernels evaluate only the one-gamma law

    def __init__(self, gammas, network):
        gammas = [float(g) for g in np.atleast_1d(np.asarray(gammas, dtype=np.float64))]
        super().__init__(gamma=float(np.mean(np.asarray(gammas))), network=network)
        self.gammas = np.asarray(gammas)

    def _gamma_eff(self, xn):
        nd = xn.dim() - 1
        a = self.network.column(self.network.aion, xn, nd)
        g = self.network.column(self.gammas, xn, nd)
        cv_k = (float(C.k_B) / float(C.m_u)) / (a * (g - 1.0))
        cv = torch.sum(xn * cv_k, dim=0)
        R_mix = torch.sum(xn * (float(C.k_B) / float(C.m_u)) / a, dim=0)
        return 1.0 + R_mix / cv

    def rt(self, rho, T, xn=None) -> EosState:
        if xn is None:
            return super().rt(rho, T, xn)
        g = self._gamma_eff(xn)
        mu = self.mu_from_xn(xn)
        cv = (float(C.k_B) / float(C.m_u)) / (mu * (g - 1.0))
        e = cv * T
        p = rho * e * (g - 1.0)
        abar, zbar = self._abar_zbar(xn, e)
        shape = e.shape
        return EosState(
            rho=rho, T=T, p=p, e=e, h=e + p / rho,
            gam1=g, cs=torch.sqrt(g * p / rho), dpdr_e=e * (g - 1.0),
            dpde=rho * (g - 1.0), dpdT=rho * cv * (g - 1.0),
            dedT=cv.expand(shape), cv=cv.expand(shape), cp=(cv * g).expand(shape),
            mu=mu.expand(shape), abar=abar.expand(shape), zbar=zbar.expand(shape),
        )

    def re(self, rho, e, xn=None) -> EosState:
        if xn is None:
            return super().re(rho, e, xn)
        g = self._gamma_eff(xn)
        mu = self.mu_from_xn(xn)
        cv = (float(C.k_B) / float(C.m_u)) / (mu * (g - 1.0))
        return self.rt(rho, e / cv, xn)

    def rp(self, rho, p, xn=None) -> EosState:
        if xn is None:
            return super().rp(rho, p, xn)
        g = self._gamma_eff(xn)
        return self.re(rho, p / (rho * (g - 1.0)), xn)
