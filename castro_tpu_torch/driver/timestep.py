"""The CFL timestep estimator (counterpart of
`castro_tpu/driver/timestep.py:estdt_cfl`; reference
`Source/driver/timestep.cpp:31`). The burning and diffusion limiters wait
with their physics (ROADMAP.md)."""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import interior_slice


def estdt_cfl(u, layout, eos, geom, ng, cfl):
    """dt = cfl * min over interior zones and dims of dx_d/(|u_d| + c)."""
    L = layout
    ui = u[interior_slice(ng, L.dim, comp_ndim=1)]
    rho = ui[L.URHO]
    rhoinv = 1.0 / rho
    e = ui[L.UEINT] * rhoinv
    xn = ui[L.UFS: L.UFS + L.nspec] * rhoinv[None]
    cs = eos.re(rho=rho, e=e, xn=xn).cs
    dt = None
    for d in range(L.dim):
        vel = torch.abs(ui[L.momentum_index(d)]) * rhoinv
        m = torch.min(geom.dx[d] / (vel + cs))
        dt = m if dt is None else torch.minimum(dt, m)
    return cfl * dt
