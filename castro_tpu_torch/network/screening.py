"""Electron screening of thermonuclear reaction rates, weak + strong
(counterpart of `castro_tpu/network/screening.py`; reference Microphysics
`screen5`).

Graboske et al. (1973) weak screening joined to ion-sphere strong
screening with the linear mixing rule

    H12 = f(Gamma_1) + f(Gamma_2) - f(Gamma_12),   Gamma_i = Z_i^{5/3} Gamma_e

where f is the Chabrier & Potekhin (1998) one-component-plasma excess free
energy whose fit drives the Helmholtz EOS Coulomb corrections
(`eos/helmholtz.py:_coulomb_terms`):

    Gamma >= 1:  f = A1 G + 4 (B1 G^{1/4} - C1 G^{-1/4}) + D1 ln G - E1
    Gamma <  1:  f = -2 C2 G^{3/2} + (A2/B2) G^{B2}

The enhancement is scor = exp(min((1-w) H_weak + w H_strong, H_CAP)), w a
linear ramp in Gamma_12 = 2 Z1 Z2 Gamma_e / (Z1^{1/3} + Z2^{1/3}) across
[0.3, 0.8]; H_CAP = 80 keeps exp() inside the float32 range.
"""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.eos.helmholtz import (_CP_A1, _CP_A2, _CP_B1, _CP_B2, _CP_C1, _CP_C2,
                                            _CP_D1, _CP_E1)
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax, clip

H_CAP = 80.0

_GEF = (C.q_e * C.q_e / C.k_B) * (4.0 * math.pi / 3.0 * C.N_A) ** (1.0 / 3.0)


def f_ocp(g):
    """CP98 OCP excess free energy per ion, in units of kT."""
    g = vmax(g, 1e-30)
    x = g ** 0.25
    f_s = _CP_A1 * g + 4.0 * (_CP_B1 * x - _CP_C1 / x) + _CP_D1 * torch.log(g) - _CP_E1
    f_w = -2.0 * _CP_C2 * g * torch.sqrt(g) + (_CP_A2 / _CP_B2) * g ** _CP_B2
    return torch.where(g >= 1.0, f_s, f_w)


def gamma_e(rho, T9, ye):
    """Electron Coulomb coupling Gamma_e = e^2 / (a_e k T) with
    a_e = (3 / 4 pi n_e)^{1/3}, n_e = rho N_A Ye."""
    T = vmax(T9, 1e-6) * 1.0e9
    return _GEF * (rho * vmax(ye, 1e-30)) ** (1.0 / 3.0) / T


def h12_weak(rho, T9, zeta, z1, z2):
    """Graboske et al. (1973) weak (Debye-Hueckel) screening exponent:
    H12 = 0.188 z1 z2 sqrt(rho zeta) T6^{-3/2}, zeta = sum (Z^2+Z) Y."""
    T6 = vmax(T9, 1e-6) * 1.0e3
    return 0.188 * z1 * z2 * torch.sqrt(rho * vmax(zeta, 0.0)) * T6 ** (-1.5)


def h12_strong(rho, T9, ye, z1, z2):
    """Ion-sphere strong screening exponent via the CP98 linear mixing rule."""
    ge = gamma_e(rho, T9, ye)
    p = 5.0 / 3.0
    return f_ocp(z1 ** p * ge) + f_ocp(z2 ** p * ge) - f_ocp((z1 + z2) ** p * ge)


def screen_pair(rho, T9, zeta, ye, z1, z2):
    """Screening enhancement factor for the reaction of charges (z1, z2)."""
    hw = h12_weak(rho, T9, zeta, z1, z2)
    hs = h12_strong(rho, T9, ye, z1, z2)
    g12 = 2.0 * z1 * z2 / (z1 ** (1.0 / 3.0) + z2 ** (1.0 / 3.0)) * gamma_e(rho, T9, ye)
    w = clip((g12 - 0.3) / 0.5, 0.0, 1.0)
    return torch.exp(clip((1.0 - w) * hw + w * hs, 0.0, H_CAP))


def plasma_moments(Y, Z):
    """(zeta, ye) = (sum (Z^2+Z) Y_k, sum Z Y_k) for molar abundances Y
    (indexable by species) and the charge table Z."""
    zeta = 0.0
    ye = 0.0
    for k in range(len(Z)):
        z = float(Z[k])
        zeta = zeta + (z * z + z) * Y[k]
        ye = ye + z * Y[k]
    return zeta, ye
