r"""Compton inelastic scattering between frequency groups (MGFLD;
counterpart of `castro_tpu/radiation/compton.py`).

The reference's group-to-group photon-energy exchange
(`Source/radiation/MGFLD.cpp:1655-1685` inelastic_scattering,
`Rad_nd.F90:238-284` ca_inelastic_sct, `RadHydro_nd.F90:9-84`
inelastic_scatter): the Larsen, Levermore, Pomraning & Sanderson (1985,
JCP 61, 359) implicit discretization of the Kompaneets operator over the
group axis. The reference solves one LAPACK dgtsv tridiagonal system per
zone; here every zone solves at once: the coefficients are
`[ngroups, *spatial]` tensors and the Thomas algorithm loops over the
short group axis, forward then back.

* ``u = Er / (nu * dlognu)`` is the spectrum in the group-measure
  normalization (``Erscale``); ``x = h nu / (m_e c^2)``.
* Interface upwind factors ``bh = exp((x_i - x_{i-1})/theta)`` encode
  detailed balance: the fixed point is the Wien spectrum at the matter
  temperature (plus the induced-scattering ``gamma*u`` correction).
* The matrix is in flux form over ``dlognu``: photon number
  ``sum_g u_g dlognu_g`` is conserved to round-off; the change in total
  radiation energy is returned and comes out of the gas energy.
* float32: ``bh - 1`` is ``expm1`` and ``ah*bh`` is ``S + ah``, so no
  ``exp`` can overflow; the exponent is clamped at 80 in float32 and 150
  in float64 (the reference's clamp).
* The reference's ``gamma`` uses a slightly wrong pi (RadHydro_nd.F90:31);
  this uses the correct pi, as the JAX package does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.utils import constants as C

_MEC2 = C.m_e * C.c_light ** 2
_TFAC = C.k_B / _MEC2                              # theta = tfac * T
_XFAC = C.hplanck / _MEC2                          # x = xfac * nu
_GAMMA = C.hplanck ** 2 / (8.0 * math.pi * (C.m_e * C.c_light) ** 3)


def _thomas(sub, diag, sup, rhs):
    """Tridiagonal solve along axis 0 of [n, *spatial] coefficients
    (sub[0] and sup[-1] are ignored): the Thomas algorithm, every zone at
    once."""
    n = diag.shape[0]
    cp_prev = dp_prev = torch.zeros_like(diag[0])
    cps, dps = [], []
    for g in range(n):
        denom = diag[g] - sub[g] * cp_prev
        cp_prev = sup[g] / denom
        dp_prev = (rhs[g] - sub[g] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [None] * n
    x_next = torch.zeros_like(diag[0])
    for g in range(n - 1, -1, -1):
        x_next = dps[g] - cps[g] * x_next
        xs[g] = x_next
    return torch.stack(xs)


def _groups(a, dtype, device):
    return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).to(device)


def inelastic_scatter(T, u, ks, dt, nugroup, xnu, dlognu):
    """One implicit Compton-exchange step on the normalized spectrum.

    T, ks: [*spatial] matter temperature and scattering opacity (1/cm);
    u: [ngroups, *spatial] = Er / (nu*dlognu); nugroup [ng], xnu [ng+1]
    group edges, dlognu [ng] (float64 arrays). Returns the updated u
    (RadHydro_nd.F90:9-84)."""
    ng = u.shape[0]
    dtype, dev = u.dtype, u.device
    sp = (1,) * (u.dim() - 1)
    x = (_XFAC * _groups(nugroup, dtype, dev)).reshape((ng,) + sp)
    xh = (_XFAC * _groups(xnu, dtype, dev)[1:ng]).reshape((ng - 1,) + sp)
    dli = (1.0 / _groups(dlognu, dtype, dev)).reshape((ng,) + sp)
    emax = 150.0 if dtype == torch.float64 else 80.0

    theta = (_TFAC * T)[None]
    sigmadt = (ks * (C.c_light * dt))[None]

    # interface j sits between groups j and j+1 (reference ah(i=j+2))
    uox = u / x
    uxh = 0.5 * (uox[:-1] + uox[1:])
    arg = torch.clamp((x[1:] - x[:-1]) / theta, max=emax)
    S = sigmadt * (xh ** 2 + _GAMMA * uxh) ** 2
    ah = S / torch.expm1(arg)        # = S/(bh-1)
    ahbh = S + ah                    # = S*bh/(bh-1), overflow-free
    cc = 1.0 / (x ** 3 + _GAMMA * u)

    zrow = torch.zeros_like(u[:1])
    # row g: DL = -dli[g] cc[g-1] ah[g-1];  DU = -dli[g] cc[g+1] ahbh[g]
    sub = torch.cat([zrow, -dli[1:] * cc[:-1] * ah], dim=0)
    sup = torch.cat([-dli[:-1] * cc[1:] * ahbh, zrow], dim=0)
    lo = torch.cat([zrow, ahbh], dim=0)   # the ah[g-1]*bh[g-1] term
    hi = torch.cat([ah, zrow], dim=0)     # the ah[g] term
    diag = 1.0 + dli * cc * (lo + hi)
    # row equilibration (each row divided by its diagonal): the condition
    # number scales with the per-step optical depth, which float32 cannot
    # absorb raw in the stiff limit
    u_new = _thomas(sub / diag, torch.ones_like(diag), sup / diag, u / diag)
    # float32 safeguard (a no-op at float64 precision): clamp round-off
    # negatives and re-impose each zone's photon number sum_g u_g dlognu_g
    u_new = torch.clamp(u_new, min=0.0)
    dl = 1.0 / dli
    n0 = torch.sum(u * dl, dim=0)
    n1 = torch.sum(u_new * dl, dim=0)
    # zones whose photon number is zero or subnormal skip the rescale: an
    # absolute floor would scale cold dim zones by ~n0/floor and flush their
    # spectrum to zero in float32
    pos = n1 > 0.0
    ratio = torch.where(pos, n0 / torch.where(pos, n1, torch.ones_like(n1)),
                        torch.ones_like(n1))
    return u_new * ratio[None]


def apply_inelastic_scattering(Er_g, T, ks, dt, nugroup, xnu, dlognu):
    """ca_inelastic_sct (Rad_nd.F90:238-284): rescale Er by the group
    measure nu*dlognu, exchange, rescale back. Er_g: [ngroups, *spatial].
    Returns (Er_new, dEr), dEr the net radiation-energy gain, which comes
    out of the gas (rho e and rho E alike, lines 278-280)."""
    ng = Er_g.shape[0]
    dtype, dev = Er_g.dtype, Er_g.device
    sp = (ng,) + (1,) * (Er_g.dim() - 1)
    erscale = (_groups(nugroup, dtype, dev) * _groups(dlognu, dtype, dev)).reshape(sp)
    u = inelastic_scatter(T, Er_g / erscale, ks, dt, nugroup, xnu, dlognu)
    Er_new = u * erscale
    return Er_new, torch.sum(Er_new - Er_g, dim=0)
