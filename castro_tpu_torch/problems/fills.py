"""Problem-level ghost-fill hooks (counterpart of `castro_tpu/problems/fills.py`).

Reference: `Source/problems/hse_fill.cpp` (the hydrostatic-equilibrium
extrapolation of flame_wave and its family, zl_ext_bc_type=1) and
`ambient.cpp`/`ambient_fill.cpp` (a fixed ambient state on a face).

Each returns a `problem_fill(u)` for `Simulation(problem_fill=...)`, which
runs it after every ghost fill. The HSE fill marches outward from the
first interior cell, one ghost layer at a time: an EOS inversion a layer
(`eos.tp` isothermal, `eos.rp` otherwise) on one row of cells, so it is a
sequence of small launches on the card."""

from __future__ import annotations

from typing import Sequence

import torch

from castro_tpu_torch.utils.tmath import vmax


def _layer(u, dim, d, i):
    """The index of layer i along spatial axis d of a component-major array."""
    idx = [slice(None)] * u.dim()
    idx[u.dim() - dim + d] = slice(i, i + 1)
    return tuple(idx)


def make_ambient_fill(sim, ambient_state, faces: Sequence[tuple]):
    """Fill the ghosts of each (dim, side) face, side "lo" or "hi", with a
    fixed conserved state [NVAR]."""
    amb = torch.as_tensor(ambient_state, dtype=sim.dtype, device=sim.device)
    ng = sim.ng
    dim = sim.layout.dim

    def fill(u):
        u = u.clone()
        for d, side in faces:
            axis = u.dim() - dim + d
            n = u.shape[axis] - 2 * ng
            idx = [slice(None)] * u.dim()
            idx[axis] = slice(0, ng) if side == "lo" else slice(n + ng, n + 2 * ng)
            ghosts = u[tuple(idx)]
            ghosts.copy_(amb.reshape([-1] + [1] * (u.dim() - 1)).expand(ghosts.shape))
        return u

    return fill


def make_hse_fill(sim, faces: Sequence[tuple], const_grav: float, isothermal=True):
    """Hydrostatic-equilibrium ghosts along the gravity direction: from the
    first interior cell, p_ghost = p_prev -/+ rho g dz outward, the density
    from the EOS at the interior's temperature (isothermal) or from (rho,
    p); the composition of the interior cell, zero velocity. The role of
    `hse_fill.cpp` (which also offers isentropic and constant-density
    variants)."""
    L = sim.layout
    ng = sim.ng
    dim = L.dim
    eos = sim.eos

    def fill(u):
        u = u.clone()
        for d, side in faces:
            axis = u.dim() - dim + d
            n = u.shape[axis] - 2 * ng
            dz = sim.geom.dx[d]
            sgn = -1.0 if side == "lo" else 1.0  # the outward direction
            i_int = ng if side == "lo" else n + ng - 1
            base = u[_layer(u, dim, d, i_int)]
            rho_b = base[L.URHO]
            xn_b = base[L.UFS:L.UFS + L.nspec] / rho_b[None]
            es_b = eos.re(rho=rho_b, e=base[L.UEINT] / rho_b, xn=xn_b)
            p = es_b.p
            T = es_b.T
            rho = rho_b
            for k in range(1, ng + 1):
                g = u[_layer(u, dim, d, i_int - k if side == "lo" else i_int + k)]
                # one layer outward: z moves by sgn dz, so dp = rho g sgn dz
                p = vmax(p + sgn * rho * const_grav * dz, 1e-30)
                es = eos.tp(T=T, p=p, xn=xn_b) if isothermal else eos.rp(rho=rho, p=p, xn=xn_b)
                rho = es.rho
                g[L.URHO] = rho
                g[L.UMX] = 0.0
                g[L.UMY] = 0.0
                g[L.UMZ] = 0.0
                g[L.UEINT] = rho * es.e
                g[L.UEDEN] = rho * es.e
                g[L.UTEMP] = es.T
                g[L.UFS:L.UFS + L.nspec] = rho[None] * xn_b
        return u

    return fill
