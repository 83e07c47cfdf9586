"""PPM reconstruction + parabola wave integration, vectorized over the grid.

Counterpart of `castro_tpu/ops/ppm.py` (reference `Source/hydro/ppm.H:11-254`):
CW84 edge interpolation with van Leer slopes, Colella & Sekora (2008)
quadratic limiters, flattening blend, and integration under the parabola
over the domain of dependence of each wave. Stencil reach: 2 zones.
`csrc/trace_ppm.cu` runs the same arithmetic per cell.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import shifted


def _vanleer_slope(sm1, s0, sp1):
    """Limited van Leer slope at the zone with neighbors sm1, sp1."""
    dsl = 2.0 * (s0 - sm1)
    dsr = 2.0 * (sp1 - s0)
    dsc = 0.5 * (sp1 - sm1)
    mag = torch.minimum(torch.abs(dsc), torch.minimum(torch.abs(dsl), torch.abs(dsr)))
    return torch.where(dsl * dsr > 0.0, torch.sign(dsc) * mag, torch.zeros_like(mag))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def ppm_reconstruct(s, flatn, ax):
    """Return (sm, sp): parabola values on the left/right edges of each zone."""
    sm2 = shifted(s, -2, ax)
    sm1 = shifted(s, -1, ax)
    sp1 = shifted(s, 1, ax)
    sp2 = shifted(s, 2, ax)

    dsvl_l = _vanleer_slope(sm2, sm1, s)
    dsvl_r = _vanleer_slope(sm1, s, sp1)
    sm = 0.5 * (s + sm1) - (1.0 / 6.0) * (dsvl_r - dsvl_l)
    sm = _clip(sm, torch.minimum(s, sm1), torch.maximum(s, sm1))

    dsvl_r2 = _vanleer_slope(s, sp1, sp2)
    sp = 0.5 * (sp1 + s) - (1.0 / 6.0) * (dsvl_r2 - dsvl_r)
    sp = _clip(sp, torch.minimum(sp1, s), torch.maximum(sp1, s))

    sm = flatn * sm + (1.0 - flatn) * s
    sp = flatn * sp + (1.0 - flatn) * s

    extremum = (sp - s) * (s - sm) <= 0.0
    big_p = torch.abs(sp - s) >= 2.0 * torch.abs(sm - s)
    big_m = torch.abs(sm - s) >= 2.0 * torch.abs(sp - s)
    # if/elif chain: extremum -> both reset; elif big_p -> sp=3s-2sm;
    # elif big_m -> sm=3s-2sp
    sp_new = torch.where(extremum, s, torch.where(big_p, 3.0 * s - 2.0 * sm, sp))
    sm_new = torch.where(extremum, s,
                         torch.where(~big_p & big_m, 3.0 * s - 2.0 * sp, sm))
    return sm_new, sp_new


def _integrate(sm, sp, s6, sigma, go_left):
    """Integral under the parabola from the appropriate edge: (Ip, Im)."""
    Ip = torch.where(go_left, sp,
                     sp - 0.5 * sigma * (sp - sm - (1.0 - (2.0 / 3.0) * sigma) * s6))
    Im = torch.where(go_left,
                     sm + 0.5 * sigma * (sp - sm + (1.0 - (2.0 / 3.0) * sigma) * s6), sm)
    return Ip, Im


def ppm_int_profile(sm, sp, s, u, c, dtdx):
    """Integrate under the parabola over the 3 waves u-c, u, u+c
    (reference `ppm_int_profile`, ppm.H:158-213): (Ip, Im), 3-tuples."""
    s6 = 6.0 * s - 3.0 * (sm + sp)
    Ips, Ims = [], []
    for speed in (u - c, u, u + c):
        Ip, Im = _integrate(sm, sp, s6, torch.abs(speed) * dtdx, speed <= 0.0)
        Ips.append(Ip)
        Ims.append(Im)
    return tuple(Ips), tuple(Ims)


def ppm_int_profile_single(sm, sp, s, lam, dtdx):
    """Single-wave variant (reference `ppm_int_profile_single`, ppm.H:216-254)."""
    s6 = 6.0 * s - 3.0 * (sm + sp)
    return _integrate(sm, sp, s6, torch.abs(lam) * dtdx, lam <= 0.0)
