"""Published rate fits for the Si28..Ni56 upper alpha chain (counterpart of
`castro_tpu/network/rates_heavy.py`, where the provenance is set out: the
aprox13 rate set, Woosley, Fowler, Holmes & Zimmerman 1978 with CF88
updates; reverse rates from detailed balance with exact inputs).

Forward fits share the WFHZ78 shape

    N_A<sv> = P * T9^(-2/3) * exp(-b / T9^(1/3) * aa),
    aa = 1 + c1 z + c2 z^2 + c3 z^3,  z = min(T9, 10)

evaluated in log space so that float32 neither overflows the prefactor
nor forms inf*0.
"""

from __future__ import annotations

import math

import torch
from castro_tpu_torch.utils.tmath import vmax, vmin, clip

# chain indices (aprox13 ordering): 5=Si28 6=S32 7=Ar36 8=Ca40 9=Ti44
# 10=Cr48 11=Fe52 -> 12=Ni56

# k(a,g)k+1 fits: P, b, (c1, c2, c3)
_AG_FITS = {
    5: (4.82e22, 61.015, (6.340e-2, 2.541e-3, -2.900e-4)),   # si28(a,g)s32
    6: (1.52e24, 66.690, (4.913e-2, 4.637e-3, -4.067e-4)),   # s32(a,g)ar36
    7: (2.81e30, 78.271, (1.458e-1, -1.069e-2, 3.790e-4)),   # ar36(a,g)ca40
    8: (4.66e24, 76.435, (1.650e-2, 5.973e-3, -3.889e-4)),   # ca40(a,g)ti44
    9: (1.37e26, 81.227, (1.066e-1, -1.102e-2, 5.324e-4)),   # ti44(a,g)cr48
    10: (1.04e23, 81.420, (6.325e-2, -5.671e-3, 2.848e-4)),  # cr48(a,g)fe52
    11: (1.05e27, 91.674, (7.846e-2, -7.430e-3, 3.723e-4)),  # fe52(a,g)ni56
}

# link k + a <-> I + p <-> (k+1) + g. For k = 5..9 the (p,a) direction is
# exothermic and fitted (I(p,a)k); for k = 10, 11 the (a,p) direction.
_PA_FITS = {
    5: (4.16e13, 25.631, (2.798e-3, 2.763e-3, -2.341e-4)),   # p31(p,a)si28
    6: (1.27e16, 31.044, (1.041e-1, -1.368e-2, 6.969e-4)),   # cl35(p,a)s32
    7: (2.10e16, 34.068, (-1.101e-1, 1.364e-2, -6.284e-4)),  # k39(p,a)ar36
    8: (4.39e17, 36.196, (-1.349e-1, 1.489e-2, -4.943e-4)),  # sc43(p,a)ca40
    9: (3.37e13, 39.110, (0.0, 0.0, 0.0)),                   # v47(p,a)ti44
}
_AP_FITS = {
    10: (1.83e26, 86.741, (1.384e-2, 1.081e-3, -5.933e-5)),  # cr48(a,p)mn51
    11: (1.30e27, 91.674, (1.367e-2, 7.428e-4, -3.050e-5)),  # fe52(a,p)co55
}
_PG_FITS = {
    5: (1.08e16, 27.042, (1.928e-1, -1.540e-2, 6.444e-4)),   # p31(p,g)s32
    6: (4.48e16, 29.483, (1.761e-1, -1.322e-2, 5.245e-4)),   # cl35(p,g)ar36
    7: (4.09e16, 31.727, (1.622e-1, -1.119e-2, 3.910e-4)),   # k39(p,g)ca40
    8: (3.85e16, 33.234, (1.023e-1, -2.242e-3, -5.463e-5)),  # sc43(p,g)ti44
    9: (2.05e17, 35.568, (9.979e-2, -2.269e-3, -6.662e-5)),  # v47(p,g)cr48
    10: (3.77e16, 37.516, (-6.510e-2, 7.448e-3, -3.000e-4)),  # mn51(p,g)fe52
    11: (6.65e16, 38.100, (9.894e-2, -3.131e-3, -2.160e-5)),  # co55(p,g)ni56
}

# 2J+1 of the intermediate odd-Z ground states; chain nuclides and He4
# are even-even 0+ (g=1), the proton g=2
_G_I = {5: 2.0, 6: 4.0, 7: 4.0, 8: 8.0, 9: 4.0, 10: 6.0, 11: 8.0}

_LN_REV = math.log(9.8685e9)  # (2 pi m_u k / h^2)^{3/2} / N_A at T9=1


def _wfhz(P, b, c, T9, lnT9):
    """log-space WFHZ78 form; clamped exp."""
    z = vmin(T9, 10.0)
    aa = 1.0 + c[0] * z + c[1] * z * z + c[2] * z * z * z
    logr = math.log(P) - (2.0 / 3.0) * lnT9 - b * aa / T9 ** (1.0 / 3.0)
    return torch.exp(clip(logr, -200.0, 85.0))


def heavy_ag(k, T9):
    """k(a,g)k+1 forward N_A<sigma v> [cm^3/mol/s] for k = 5..11."""
    P, b, c = _AG_FITS[k]
    return _wfhz(P, b, c, T9, torch.log(T9))


def link_rates(k, T9, A, q_ap, q_pg, aI):
    """(lam_ap, lam_pa, lam_pg, lam_gp) for the k-th (a,p)(p,g) link,
    unscreened; A the chain's aion, Q-values in MeV."""
    lnT9 = torch.log(T9)
    gI = _G_I[k]
    kT = 11.6045 / T9  # 1/kT in 1/MeV

    P, b, c = _PG_FITS[k]
    lam_pg = _wfhz(P, b, c, T9, lnT9)
    lam_gp = lam_pg * torch.exp(clip(_LN_REV + 1.5 * lnT9 + 1.5 * math.log(aI * 1.0 / A[k + 1])
        + math.log(gI * 2.0) - q_pg * kT, -200.0, 85.0))

    if k in _PA_FITS:  # I(p,a)k exothermic
        P, b, c = _PA_FITS[k]
        lam_pa = _wfhz(P, b, c, T9, lnT9)
        ratio = (gI * 2.0) * (aI * 1.0 / (A[k] * 4.0)) ** 1.5
        lam_ap = lam_pa * ratio * torch.exp(clip(q_ap * kT, -200.0, 0.0))
    else:  # k(a,p)I exothermic (cr48, fe52)
        P, b, c = _AP_FITS[k]
        lam_ap = _wfhz(P, b, c, T9, lnT9)
        ratio = (A[k] * 4.0 / (aI * 1.0)) ** 1.5 / (gI * 2.0)
        lam_pa = lam_ap * ratio * torch.exp(clip(-q_ap * kT, -200.0, 0.0))
    return lam_ap, lam_pa, lam_pg, lam_gp


def link_flow_terms(k, T9, A, q_ap, q_pg, aI):
    """(lam_ap, frac, K) for the compensated net-flow form of the k-th
    link, flow = scr_a lam_ap frac (rho Y_a Y_k - K Y_{k+1}), with
    frac = lam_pg/(lam_pg+lam_pa) and the (a,g) Saha factor
    K = 9.8685e9 T9^1.5 (4 A_k / A_{k+1})^1.5 exp(-(q_ap+q_pg)/kT)."""
    lnT9 = torch.log(T9)
    lam_ap, lam_pa, lam_pg, _ = link_rates(k, T9, A, q_ap, q_pg, aI)
    frac = lam_pg / vmax(lam_pg + lam_pa, 1e-300)
    lnK_const = _LN_REV + 1.5 * math.log(4.0 * A[k] / A[k + 1])
    q_kT = (q_ap + q_pg) * 11.6045
    K = torch.exp(clip(lnK_const + 1.5 * lnT9 - q_kT / T9, -200.0, 85.0))
    return lam_ap, frac, K
