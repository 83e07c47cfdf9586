"""Miller-Colella shock flattening (reference `Castro::uflatten`,
`Source/hydro/flatten.cpp:13-167`; counterpart of
`castro_tpu/ops/flatten.py`): per-direction coefficient from pressure
jumps + velocity convergence, evaluated at the zone and its upwind
neighbor, combined across directions with a min. Stencil reach: 3 zones.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import shifted

SHKTST = 0.33
ZCUT1 = 0.75
ZCUT2 = 0.85
DZCUT = 1.0 / (ZCUT2 - ZCUT1)
SMALL_PRES = 1.0e-200


def small_pressure(dtype) -> float:
    """Floor of the pressure-jump denominator: 1e-200 flushes to zero in
    f32 and would make zeta = 0/0 in uniform regions."""
    return max(SMALL_PRES, float(torch.finfo(dtype).tiny))


def uflatten(q, layout, pres_comp=None):
    """Return flatn[grid] in [0,1]; 1 = no flattening. `pres_comp` is the
    pressure that detects shocks (default QPRES; radiation runs also
    flatten on QPTOT, Castro_ctu_hydro.cpp:236-239)."""
    L = layout
    dim = L.dim
    p = q[L.QPRES if pres_comp is None else pres_comp]
    flatn = torch.ones_like(p)
    small = small_pressure(p.dtype)
    one, zero = torch.ones_like(p), torch.zeros_like(p)
    for d in range(dim):
        vel = q[L.velocity_index(d)]
        dp = shifted(p, 1, d) - shifted(p, -1, d)
        denom = torch.clamp(torch.abs(shifted(p, 2, d) - shifted(p, -2, d)),
                            min=small)
        zeta = torch.abs(dp) / denom
        z = torch.clamp(DZCUT * (zeta - ZCUT1), 0.0, 1.0)
        tst = torch.where(shifted(vel, -1, d) - shifted(vel, 1, d) >= 0.0, one, zero)
        tmp = torch.minimum(shifted(p, 1, d), shifted(p, -1, d))
        chi = torch.where(torch.abs(dp) > SHKTST * tmp, tst, zero)
        zchi = chi * z
        # the same quantity at the upwind neighbor i-ishft
        zchi2 = torch.where(dp > 0.0, shifted(zchi, -1, d), shifted(zchi, 1, d))
        flatn = torch.minimum(flatn, 1.0 - torch.maximum(zchi, zchi2))
    return flatn
