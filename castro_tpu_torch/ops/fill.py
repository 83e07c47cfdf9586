"""Physical boundary-condition ghost fill (counterpart of
`castro_tpu/ops/fill.py:fill_ghosts`).

Reference behavior: AMReX FillPatch physical BCs + `ca_statefill`
(`Source/problems/Castro_bc_fill_nd.cpp:11-180`): Interior(0)/periodic,
Outflow(2) first-order extrapolation, Symmetry(3)/SlipWall(4) mirror + odd
normal velocity, NoSlipWall(5) mirror + all velocities odd. Inflow(1) gets
the outflow baseline, which the problem's `problem_fill(u, t)` hook then
overwrites (the reference's problem_bc_fill).

One gather per axis (wrap, clamp or reflect index map) in x, y, z order,
then the sign flips of that axis: a ghost cell takes the value of its source
cell composed axis by axis. `ops/kernels.py:clean_fill` fuses this with
`clean_state` on the card. `fill_face` is the same for one face-centred
field of MHD (counterpart of `castro_tpu/ops/fill.py:fill_face`).
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence

import numpy as np
import torch

# AMReX phys_bc integer codes
INTERIOR, INFLOW, OUTFLOW, SYMMETRY, SLIPWALL, NOSLIPWALL = 0, 1, 2, 3, 4, 5
WALLS = (SYMMETRY, SLIPWALL, NOSLIPWALL)


def axis_fill_index(N, ng, lo, hi):
    """Ghost -> source index map along one grown axis: wrap (periodic),
    clamp (outflow/inflow baseline) or reflect (symmetry/walls)."""
    n = N - 2 * ng
    idx = np.arange(N)
    if lo == INTERIOR:
        idx[:ng] = np.arange(n, n + ng)
    elif lo in (OUTFLOW, INFLOW):
        idx[:ng] = ng
    else:
        idx[:ng] = np.arange(2 * ng - 1, ng - 1, -1)
    if hi == INTERIOR:
        idx[n + ng:] = np.arange(ng, 2 * ng)
    elif hi in (OUTFLOW, INFLOW):
        idx[n + ng:] = n + ng - 1
    else:
        idx[n + ng:] = np.arange(n + ng - 1, n - 1, -1)
    return idx


def _face_fill_index_normal(N, ng, lo, hi):
    """Ghost index map and parity sign along the face-normal axis of a
    face-registered field (face i-1/2 at index i; interior faces ng ..
    ng+n-1, the hi domain face ng+n in the ghost margin). Walls mirror
    about the wall face with odd parity, the hi wall face pinned to 0;
    outflow and inflow clamp; periodic wraps (face j to j -/+ n)."""
    n = N - 2 * ng
    idx = np.arange(N)
    sgn = np.ones(N)
    for j in range(ng):
        k = ng - 1 - j  # distance below the lo wall face (at index ng)
        if lo == INTERIOR:
            idx[j] = j + n
        elif lo in WALLS:
            idx[j] = ng + 1 + k
            sgn[j] = -1.0
        else:
            idx[j] = ng
    for j in range(ng + n, N):
        k = j - (ng + n)
        if hi == INTERIOR:
            idx[j] = j - n
        elif hi in WALLS:
            if k == 0:
                idx[j] = ng + n - 1
                sgn[j] = 0.0  # the wall face itself: no penetration
            else:
                idx[j] = ng + n - k
                sgn[j] = -1.0
        else:
            idx[j] = ng + n - 1
    return idx, sgn


def _scale_axis(b, d, dim, sv):
    """b times the numpy vector sv along axis d (a no-op where sv is all 1)."""
    if np.all(sv == 1.0):
        return b
    shape = [1] * dim
    shape[d] = len(sv)
    return b * torch.as_tensor(sv.reshape(shape), dtype=b.dtype, device=b.device)


def fill_face(b, df, dim, ng, lo_bc, hi_bc):
    """The ghost margin of one face field normal to `df` (face i-1/2 at
    index i, ng ghosts a side; reference `filfc.f90` and the face-variable
    BC records of Castro_setup). Along df: periodic wrap, outflow clamp,
    or an odd mirror about the wall face with the hi wall face pinned to
    0 (the velocity-like normal component). Across it the field is
    cell-registered: wrap, clamp or an even mirror, odd at a no-slip wall
    (like tangential velocity)."""
    for d in range(dim):
        N = b.shape[d]
        n = N - 2 * ng
        lo, hi = lo_bc[d], hi_bc[d]
        if d == df:
            idx, sgn = _face_fill_index_normal(N, ng, lo, hi)
            b = _scale_axis(torch.index_select(b, d, torch.as_tensor(idx, device=b.device)),
                            d, dim, sgn)
        else:
            b = torch.index_select(b, d, torch.as_tensor(axis_fill_index(N, ng, lo, hi),
                                                         device=b.device))
            sv = np.ones(N)
            if lo == NOSLIPWALL:
                sv[:ng] = -1.0
            if hi == NOSLIPWALL:
                sv[n + ng:] = -1.0
            b = _scale_axis(b, d, dim, sv)
    return b


def axis_flips(layout, d, lo, hi):
    """{component: (flip_lo, flip_hi)} of the reflection-odd momenta on
    the wall faces of axis d (NoSlipWall flips every velocity)."""
    dim = layout.dim
    out = {}
    for side, bc in ((0, lo), (1, hi)):
        if bc not in WALLS:
            continue
        comps = {layout.momentum_index(d)}
        if bc == NOSLIPWALL:
            comps |= {layout.momentum_index(k) for k in range(dim)}
        for c in comps:
            flags = out.setdefault(c, [False, False])
            flags[side] = True
    return out


def fill_ghosts(u: torch.Tensor, layout, lo_bc: Sequence[int],
                hi_bc: Sequence[int], ng: int, problem_fill: Optional[Callable] = None,
                t=0.0) -> torch.Tensor:
    """Fill ng ghost cells on every face of a component-major grown array;
    then `problem_fill(u, t)` (or `problem_fill(u)`), when given, sets the
    inflow ghosts, time-dependent ones included (double Mach reflection)."""
    dim = layout.dim
    for d in range(dim):
        axis = u.dim() - dim + d
        N = u.shape[axis]
        n = N - 2 * ng
        lo, hi = lo_bc[d], hi_bc[d]
        idx = torch.as_tensor(axis_fill_index(N, ng, lo, hi), device=u.device)
        u = torch.index_select(u, axis, idx)
        flips = axis_flips(layout, d, lo, hi)
        if flips:
            shape = [1] * dim
            shape[d] = N
            u = u.clone()
            for comp, (flo, fhi) in sorted(flips.items()):
                sv = np.ones(N)
                if flo:
                    sv[:ng] = -1.0
                if fhi:
                    sv[n + ng:] = -1.0
                u[comp] = u[comp] * torch.as_tensor(
                    sv.reshape(shape), dtype=u.dtype, device=u.device)
    return apply_problem_fill(u, problem_fill, t)


def apply_problem_fill(u, problem_fill, t):
    """`problem_fill(u, t)`, or `problem_fill(u)` for a hook of one
    argument (`castro_tpu/ops/fill.py:apply_problem_fill`)."""
    if problem_fill is None:
        return u
    try:
        n = len(inspect.signature(problem_fill).parameters)
    except (TypeError, ValueError):
        n = 1
    return problem_fill(u, t) if n >= 2 else problem_fill(u)

