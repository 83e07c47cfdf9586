"""Limited slopes for PLM reconstruction (counterpart of
`castro_tpu/ops/slope.py`).

Reference: `Source/hydro/slope.H:26-241`: `uslope` (2nd-order MC and the
4th-order two-pass MC limiter, flattening applied) and `pslope` (the
well-balanced pressure slope with the local hydrostatic gradient
subtracted, `use_pslope`)."""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import shifted


def _lim(dlft, drgt):
    """The MC limit: min(|dlft|, |drgt|) where they agree in sign, else 0."""
    return torch.where(dlft * drgt >= 0.0, torch.minimum(torch.abs(dlft), torch.abs(drgt)),
                       torch.zeros_like(dlft))


def _mc(dlft, drgt, dcen):
    return torch.sign(dcen) * torch.minimum(torch.abs(dcen), _lim(dlft, drgt))


def _fourth_order(dlft, drgt, dcen, ax):
    """The second pass of the 4th-order MC limiter."""
    df = _mc(dlft, drgt, dcen)
    dq = (4.0 / 3.0) * dcen - (1.0 / 6.0) * (shifted(df, 1, ax) + shifted(df, -1, ax))
    return torch.sign(dcen) * torch.minimum(torch.abs(dq), _lim(dlft, drgt))


def uslope(q, flatn, ax, order=4):
    """Limited slope of q along ax (per zone). order=2: MC limiter;
    order=4: two-pass 4th-order MC (reference plm_limiter=2, the default)."""
    dlft = 2.0 * (q - shifted(q, -1, ax))
    drgt = 2.0 * (shifted(q, 1, ax) - q)
    dcen = 0.25 * (dlft + drgt)
    if order == 2:
        return flatn * _mc(dlft, drgt, dcen)
    return flatn * _fourth_order(dlft, drgt, dcen, ax)


def pslope(p, rho, src_n, flatn, ax, dx, cutoff_density=-1e20):
    """Well-balanced pressure slope: the local hydrostatic differences
    rho g dx are subtracted before limiting and the in-cell gradient added
    back (reference `pslope`, slope.H). src_n is the normal-direction
    acceleration (srcQ[QUN])."""
    rm1, rp1 = shifted(rho, -1, ax), shifted(rho, 1, ax)
    gm1, gp1 = shifted(src_n, -1, ax), shifted(src_n, 1, ax)
    dlft = p - shifted(p, -1, ax) - 0.25 * (rho + rm1) * (src_n + gm1) * dx
    drgt = shifted(p, 1, ax) - p - 0.25 * (rho + rp1) * (src_n + gp1) * dx
    dlft = 2.0 * dlft
    drgt = 2.0 * drgt
    dcen = 0.25 * (dlft + drgt)
    dp = flatn * _fourth_order(dlft, drgt, dcen, ax)
    dp = dp + rho * src_n * dx
    return torch.where(rho >= cutoff_density, dp, uslope(p, flatn, ax))
