"""Helpers for problem initialization (counterpart of
`castro_tpu/problems/util.py`)."""

from __future__ import annotations

import torch


def fill_from_prim(sim, u, rho, vel, p=None, T=None, xn=None):
    """Fill the conserved state (everywhere, ghosts included) from primitive
    fields. `vel` is a 3-tuple of tensors/scalars; `xn` [nspec, ...] mass
    fractions (default: first species = 1)."""
    L = sim.layout
    shape = u.shape[1:]

    def full(a):
        return torch.as_tensor(a, dtype=u.dtype, device=u.device).expand(shape)

    rho = full(rho)
    vx, vy, vz = (full(v) for v in vel)
    if xn is None:
        xn = torch.zeros((L.nspec,) + tuple(shape), dtype=u.dtype, device=u.device)
        xn[0] = 1.0
    else:
        xn = torch.as_tensor(xn, dtype=u.dtype, device=u.device).expand((L.nspec,) + tuple(shape))
    if p is not None:
        es = sim.eos.rp(rho=rho, p=full(p), xn=xn)
    else:
        es = sim.eos.rt(rho=rho, T=full(T), xn=xn)
    ke = 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    u = u.clone()
    u[L.URHO] = rho
    u[L.UMX] = rho * vx
    u[L.UMY] = rho * vy
    u[L.UMZ] = rho * vz
    u[L.UEINT] = rho * es.e
    u[L.UEDEN] = rho * es.e + ke
    u[L.UTEMP] = es.T
    u[L.UFS: L.UFS + L.nspec] = xn * rho[None]
    if L.naux > 0:
        u[L.UFX: L.UFX + L.naux] = 0.0
    return u


def column_state(sim, u, model):
    """rho, T [grid] and xn [nspec, grid] of a 1D model in y (a dict of
    `utils/initial_models.py`), interpolated to u's cell centres, float64."""
    from castro_tpu_torch.utils.initial_models import model_to_grid

    shape = tuple(u.shape[1:])
    vals = model_to_grid(model, sim.geom.cell_centers_1d(1, sim.ng).double().cpu().numpy())

    def col(v):
        return torch.as_tensor(v, dtype=torch.float64, device=u.device)[None, :].expand(shape)

    xn = torch.stack([col(vals[f"spec_{k}"]) for k in range(sim.layout.nspec)])
    return col(vals["density"]), col(vals["temperature"]), xn


def model_state(sim, u, model, dist, nspec=None):
    """rho, T [grid] and, with nspec, xn [nspec, grid] of a 1D model (a
    dict of `utils/initial_models.py`) interpolated to the distances
    `dist` [grid] on the host, as tensors of u's dtype and device."""
    from castro_tpu_torch.utils.initial_models import model_to_grid

    shape = tuple(u.shape[1:])
    vals = model_to_grid(model, dist.expand(shape).double().cpu().numpy().reshape(-1))

    def grid(v):
        return torch.as_tensor(v, dtype=u.dtype, device=u.device).reshape(shape)

    rho, T = grid(vals["density"]), grid(vals["temperature"])
    if nspec is None:
        return rho, T
    return rho, T, torch.stack([grid(vals[f"spec_{k}"]) for k in range(nspec)])


def radius_from_origin(sim, shape):
    """|x| in 1D, sqrt(x^2 + y^2 (+ z^2)) otherwise, at u's cell centres."""
    g = sim.geom
    axes = [g.cell_centers(d, sim.ng).expand(shape) for d in range(sim.layout.dim)]
    if len(axes) == 1:
        return axes[0]
    return torch.sqrt(sum(a * a for a in axes))
