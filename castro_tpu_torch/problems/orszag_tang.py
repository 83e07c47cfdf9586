"""Orszag-Tang vortex (reference `Exec/mhd_tests/OrszagTang`; counterpart of
`castro_tpu/problems/orszag_tang.py`): the standard 2D MHD turbulence
benchmark. Periodic unit square, gamma = 5/3."""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

GAMMA = 5.0 / 3.0


def make_params(n=128, dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=(n, n))
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", lo_bc=(0, 0), hi_bc=(0, 0), cfl=0.4, do_mhd=1,
                  small_dens=1e-12, small_temp=1e-12, small_pres=1e-15)
    p = p.with_ns("eos", eos_gamma=GAMMA)
    p = p.with_ns("tpu", dtype=dtype)
    return p


def problem_init(sim, u, b):
    """The standard OT data: rho = gamma^2/(4 pi), p = gamma/(4 pi),
    v = (-sin 2 pi y, sin 2 pi x), B from the vector potential A_z = B0
    (cos(4 pi x)/(4 pi) + cos(2 pi y)/(2 pi)), B0 = 1/sqrt(4 pi). `sim` is
    an MhdSimulation, a Simulation or an AMR window's view of one."""
    base = getattr(sim, "base", sim)
    g = base.geom
    ng = base.ng
    twopi = 2.0 * math.pi
    x = g.cell_centers(0, ng)
    y = g.cell_centers(1, ng)
    rho0 = GAMMA ** 2 / (4.0 * math.pi)
    p0 = GAMMA / (4.0 * math.pi)
    vx = -torch.sin(twopi * y) * torch.ones_like(x)
    vy = torch.sin(twopi * x) * torch.ones_like(y)
    u = fill_from_prim(base, u, rho0, (vx, vy, 0.0), p=p0)

    B0 = 1.0 / math.sqrt(4.0 * math.pi)
    # face-centred from A_z, for div B = 0: Bx = dA/dy at x-faces, By =
    # -dA/dx at y-faces
    xf = g.faces_1d(0, ng)[:-1]
    yf = g.faces_1d(1, ng)[:-1]
    xc1 = g.cell_centers_1d(0, ng)
    yc1 = g.cell_centers_1d(1, ng)
    shape = u.shape[1:]
    bx = ((-B0 * torch.sin(twopi * yc1))[None, :] * torch.ones_like(xf)[:, None]).expand(shape)
    by = ((B0 * torch.sin(2.0 * twopi * xc1))[:, None] * torch.ones_like(yf)[None, :]).expand(shape)
    bz = torch.zeros(shape, dtype=u.dtype, device=u.device)
    return u, (bx, by, bz)
