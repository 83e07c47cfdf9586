"""Thermal neutrino energy losses (counterpart of
`castro_tpu/network/neutrino.py`; reference Microphysics `sneut5`, called
from every aprox-network RHS).

The pair-annihilation channel is the Itoh et al. (1996, ApJS 102, 411)
fitting formula; bremsstrahlung the liquid-metal leading term eps ~ 0.3034
(Z^2/A) T8^6 erg/g/s (Itoh & Kohyama 1983). The photo- and
plasma-neutrino channels of the full sneut5 are not included, as in the
JAX package.
"""

from __future__ import annotations

import torch
from castro_tpu_torch.utils.tmath import vmax


def sneut_pair(rho, T, abar, zbar):
    """Pair-annihilation neutrino loss rate, erg/g/s (Itoh et al. 1996):
    Q_pair = g(lambda) exp(-2/lambda) f_pair; lambda = T/5.9302e9 K,
    xi = ((rho/mu_e)/1e9)^(1/3)/lambda."""
    mu_e_inv = zbar / abar  # 1/mu_e
    rm = rho * mu_e_inv
    lam = vmax(T / 5.9302e9, 1e-10)
    xi = (rm * 1e-9) ** (1.0 / 3.0) / lam

    gl = 1.0 - 13.04 * lam**2 + 133.5 * lam**4 + 1534.0 * lam**6 + 918.6 * lam**8
    gl = vmax(gl, 0.0)

    # low-T (T < 1e10 K) and high-T coefficient sets, switched at 1e10
    def fpair(a0, a1, a2, b1, b2, b3, c):
        num = (a0 + a1 * xi + a2 * xi * xi) * torch.exp(-c * xi)
        den = xi**3 + b1 / lam + b2 / lam**2 + b3 / lam**3
        return num / vmax(den, 1e-300)

    f_lo = fpair(6.002e19, 2.084e20, 1.872e21, 9.383e-1, -4.141e-1, 5.829e-2, 5.5924)
    f_hi = fpair(6.002e19, 2.084e20, 1.872e21, 1.2383, -8.141e-1, 0.0, 4.9924)
    f = torch.where(T < 1.0e10, f_lo, f_hi)

    q_cm3 = gl * torch.exp(-2.0 / lam) * f  # erg / cm^3 / s
    return q_cm3 / vmax(rho, 1e-300)


def sneut_brems(rho, T, abar, zbar):
    """Bremsstrahlung neutrino losses, erg/g/s: 0.3034 (Z^2/A) T8^6."""
    T8 = T * 1e-8
    return 0.3034 * (zbar * zbar / abar) * T8**6


def sneut(rho, T, abar, zbar):
    """Total implemented thermal neutrino loss, erg/g/s (>= 0)."""
    return sneut_pair(rho, T, abar, zbar) + sneut_brems(rho, T, abar, zbar)
