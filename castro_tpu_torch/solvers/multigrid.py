"""Matrix-free geometric multigrid for cell-centred elliptic problems
(counterpart of `castro_tpu/solvers/multigrid.py`, its single-device part).

The reference's linear-solver stack: AMReX `MLPoisson`/`MLABecLaplacian` +
`MLMG` for gravity and thermal diffusion (`Source/gravity/Gravity.cpp:
3500-3558`, `Source/diffusion/Diffusion.H:104`), Hypre for radiation
(`Source/radiation/HypreABec.cpp`). The operator is the general ABec form
of MLABecLaplacian:

    L(u) = alpha * a(x) * u - beta * div( b(x) grad u )

V-cycles with red-black Gauss-Seidel smoothing (red then black),
full-weighting restriction, bilinear prolongation and a dense direct solve
on the coarsest level. With `rtol` the V-cycles run until max|res| <=
rtol * max|rhs| + atol or `n_vcycles`, the JAX package's `lax.while_loop`
as a Python loop with one host read of the residual norm a V-cycle; else
exactly `n_vcycles`.

BCs per face: 'periodic', 'dirichlet' (value on the domain face, array or
scalar), 'neumann' (zero gradient), 'robin' (ghost = A*interior + G).
Cell-centred ghosts: dirichlet ghost = 2*f - interior; neumann ghost =
interior.

The level plan (shapes, checkerboards, inverse diagonals, the coarsest
level's dense operator and its LU factors) is built once per problem shape
and boundary set when no coefficient arrays are given, and reused across
solves. On the card the V-cycles of a solve past its first replay one
CUDA graph of the V-cycle, captured for the solve (the level plan's
tensors fixed within it): eagerly a V-cycle is hundreds of small launches
and its time the host's. With `nb=1` one call solves a batch of
independent problems (the
groups of a multigroup radiation update): the rhs, the coefficients and
the BC values carry a leading batch axis (the metric does not), and with
`rtol` each problem stops on its own test, its iterate frozen once it
has converged, as the JAX package's vmapped while_loop freezes it. The
distributed solve (`axis_names`, halo exchange, agglomerated coarse
levels) is not ported (ROADMAP.md, queue 1 item 13).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from castro_tpu_torch.utils.cuda_graph import capture

PERIODIC, DIRICHLET, NEUMANN, ROBIN = 0, 1, 2, 3

_BC_CODE = {"periodic": PERIODIC, "dirichlet": DIRICHLET,
            "neumann": NEUMANN, "robin": ROBIN}

#: the largest coarsest level solved directly (above it, coarse_sweeps)
DIRECT_MAX = 1024


def _take(u, axis, lo, hi):
    idx = [slice(None)] * u.dim()
    idx[axis] = slice(lo, hi)
    return tuple(idx)


def _pad_face_vals(vals, d, ndim, nb=0):
    """Edge-pad a face-plane array (interior-sized, size 1 along d, after
    `nb` batch axes) to cover the grown ghost slab's corners; a scalar,
    None (0) or an axis of size 1 (which broadcasts) as it is."""
    if vals is None:
        return 0.0
    if isinstance(vals, torch.Tensor) and vals.dim() == nb + ndim:
        for k in range(ndim):
            n = vals.shape[nb + k]
            if k != d and n > 1:
                idx = torch.arange(-1, n + 1, device=vals.device).clamp_(0, n - 1)
                vals = vals.index_select(nb + k, idx)
        return vals
    return vals


def _fill(u, bl, bh, bvl=None, bvh=None, nb=0):
    """Fill 1 ghost cell per face of a grown array in place; the spatial
    axes start at `nb` (a batch of arrays ahead of them)."""
    dim = u.dim() - nb
    for d in range(dim):
        ax = nb + d
        n = u.shape[ax] - 2
        for side, code in (("lo", bl[d]), ("hi", bh[d])):
            ghost = u.narrow(ax, 0 if side == "lo" else n + 1, 1)
            interior = u.narrow(ax, 1 if side == "lo" else n, 1)
            if code == PERIODIC:
                ghost.copy_(u.narrow(ax, n if side == "lo" else 1, 1))
            elif code == NEUMANN:
                ghost.copy_(interior)
            elif code == ROBIN:
                # ghost = A*interior + G (mixed/Marshak radiation BCs);
                # homogeneous correction levels (vals None) degrade to Neumann
                src = bvl if side == "lo" else bvh
                vals = src[d] if src is not None else None
                if vals is None:
                    ghost.copy_(interior)
                else:
                    A = _pad_face_vals(vals[0], d, dim, nb)
                    G = _pad_face_vals(vals[1], d, dim, nb)
                    ghost.copy_(A * interior + G)
            else:  # DIRICHLET
                src = bvl if side == "lo" else bvh
                vals = _pad_face_vals(src[d] if src is not None else None, d, dim, nb)
                ghost.copy_(2.0 * vals - interior)
    return u


def _grow(u, nb=0):
    dim = u.dim() - nb
    return torch.nn.functional.pad(u, (1, 1) * dim)


def _shrink(u):
    return u[(slice(1, -1),) * u.dim()]


def fill_bc(u, bc_lo, bc_hi, bc_vals_lo=None, bc_vals_hi=None, nb=0):
    """Fill 1 ghost cell per face of a grown array [n1+2, n2+2, ...] (after
    `nb` batch axes); returns a new array."""
    return _fill(u.clone(), bc_lo, bc_hi, bc_vals_lo, bc_vals_hi, nb)


def _apply(u_g, acoef, bcoefs, alpha, beta, dx, metric=None, nb=0, cb=None):
    """L(u) on the interior of a grown, ghost-filled u_g whose spatial axes
    start at nb; the face coefficients' spatial axes start at cb (default
    nb: batched with u; 0 for coefficients shared by a batch)."""
    cb = nb if cb is None else cb
    dim = u_g.dim() - nb
    u = u_g[(slice(None),) * nb + (slice(1, -1),) * dim]
    out = alpha * acoef * u if acoef is not None else alpha * u
    vinv = 1.0 / metric["vol"] if metric is not None else None
    for d in range(dim):
        # interior along every axis but d
        v = u_g
        for k in range(dim):
            if k != d:
                v = v.narrow(nb + k, 1, v.shape[nb + k] - 2)
        n = v.shape[nb + d] - 2
        c = v.narrow(nb + d, 1, n)
        lo = v.narrow(nb + d, 0, n)
        hi = v.narrow(nb + d, 2, n)
        b = bcoefs[d] if bcoefs is not None else None
        if b is None:
            f_lo, f_hi = (c - lo), (hi - c)
        else:
            f_lo, f_hi = b.narrow(cb + d, 0, n) * (c - lo), b.narrow(cb + d, 1, n) * (hi - c)
        if metric is not None:
            A = metric["areas"][d]
            flux_div = (A.narrow(d, 1, n) * f_hi - A.narrow(d, 0, n) * f_lo) * vinv / dx[d]
        else:
            flux_div = (f_hi - f_lo) / (dx[d] * dx[d])
        out = out - beta * flux_div
    return out


def apply_op(u_g, acoef, bcoefs, alpha, beta, dx, metric=None):
    """L(u) on the interior given a grown (ghost-filled) u_g.

    bcoefs[d]: face-registered coefficient (interior faces only: the
    interior's shape across d, n+1 along d) or None (1). metric
    (curvilinear): {"areas": [face-registered area per dim], "vol": cell
    volumes}; the divergence becomes (1/V) sum_d (A_hi b_hi du_hi - A_lo
    b_lo du_lo)/dx_d (the MLABec operator in general geometry)."""
    return _apply(u_g, acoef, bcoefs, alpha, beta, dx, metric)


def _diag(acoef, bcoefs, alpha, beta, dx, shape, dtype, metric=None, device=None, nb=0):
    diag = alpha * (acoef if acoef is not None else torch.ones(shape, dtype=dtype,
                                                                device=device))
    vinv = 1.0 / metric["vol"] if metric is not None else None
    for d in range(len(dx)):
        b = bcoefs[d] if bcoefs is not None else None
        n = shape[d]
        if b is None:
            b_lo = b_hi = 1.0
        else:
            b_lo, b_hi = b.narrow(nb + d, 0, n), b.narrow(nb + d, 1, n)
        if metric is not None:
            A = metric["areas"][d]
            diag = diag + beta * (A.narrow(d, 0, n) * b_lo + A.narrow(d, 1, n) * b_hi) \
                * vinv / dx[d]
        else:
            diag = diag + beta * (b_lo + b_hi) / (dx[d] * dx[d])
    return diag


def _restrict(r, nb=0):
    """Full weighting: the mean of the 2^d fine children of each coarse cell."""
    out = r
    for d in range(nb, r.dim()):
        n = out.shape[d]
        out = out.reshape(out.shape[:d] + (n // 2, 2) + out.shape[d + 1:]).mean(dim=d + 1)
    return out


def _coarsen_metric(metric, dim):
    if metric is None:
        return None
    vol_c = _restrict(metric["vol"]) * (2 ** dim)
    areas = []
    for d in range(dim):
        out = metric["areas"][d]
        for k in range(dim):
            if k == d:
                idx = [slice(None)] * out.dim()
                idx[k] = slice(0, None, 2)
                out = out[tuple(idx)]
            else:
                n = out.shape[k]
                out = out.reshape(out.shape[:k] + (n // 2, 2) + out.shape[k + 1:]).sum(dim=k + 1)
        areas.append(out)
    return {"areas": areas, "vol": vol_c}


@functools.lru_cache(maxsize=64)
def _checkerboards(shape, device=None):
    idx = sum(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    red = torch.as_tensor((idx % 2) == 0, device=device)
    return red, ~red


def _prolong(e_c, fill, nb=0):
    """(Bi/tri)linear cell-centred prolongation: per dim, fine[2i] = 3/4 c[i]
    + 1/4 c[i-1], fine[2i+1] = 3/4 c[i] + 1/4 c[i+1]. `fill` supplies the
    coarse ghosts (homogeneous correction BCs)."""
    out = fill(e_c)
    for d in range(nb, e_c.dim()):
        m = out.shape[d]
        c = out.narrow(d, 1, m - 2)
        lo = out.narrow(d, 0, m - 2)
        hi = out.narrow(d, 2, m - 2)
        even = 0.75 * c + 0.25 * lo
        odd = 0.75 * c + 0.25 * hi
        st = torch.stack([even, odd], dim=d + 1)
        out = st.reshape(st.shape[:d] + (2 * c.shape[d],) + st.shape[d + 2:])
    return out


def _coarsen_face_coef(b, d, nb=0):
    """Coarsen a face-registered coefficient: every other face along its own
    axis, pair means along the others."""
    if b is None:
        return None
    out = b
    d = nb + d
    for k in range(nb, out.dim()):
        if k == d:
            idx = [slice(None)] * out.dim()
            idx[k] = slice(0, None, 2)
            out = out[tuple(idx)]
        else:
            n = out.shape[k]
            out = out.reshape(out.shape[:k] + (n // 2, 2) + out.shape[k + 1:]).mean(dim=k + 1)
    return out


class _Level:
    """One level of the plan: its shape, dx, coefficients, checkerboards and
    inverse diagonal."""

    def __init__(self, shape, dx, acoef, bcoefs, metric, alpha, beta, dtype, device, nb=0):
        self.shape, self.dx = shape, dx
        self.acoef, self.bcoefs, self.metric = acoef, bcoefs, metric
        self.red, self.black = _checkerboards(shape, device)
        self.inv_diag = 1.0 / _diag(acoef, bcoefs, alpha, beta, dx, shape, dtype, metric,
                                    device, nb)
        self.lu = None  # the coarsest level's dense operator, factored


class Plan:
    """The static level hierarchy of one solve: down to `min_size` or an odd
    extent, the coarsest level's dense operator built and factored once
    when it has at most DIRECT_MAX cells. `nb` = 1: the coefficients carry
    a batch axis of `batch` problems, each with its own dense operator."""

    def __init__(self, shape, dx, bl, bh, alpha, beta, acoef=None, bcoefs=None, metric=None,
                 min_size=4, dtype=torch.float64, device="cpu", nb=0, batch=1):
        self.bl, self.bh, self.alpha, self.beta = bl, bh, alpha, beta
        self.dim = len(shape)
        self.nb = nb
        self.singular = all(c not in (DIRICHLET, ROBIN) for c in bl + bh) and alpha == 0.0
        self.levels = []
        shape, ldx = tuple(shape), tuple(dx)
        la, lb, lm = acoef, bcoefs, metric
        while True:
            self.levels.append(_Level(shape, ldx, la, lb, lm, alpha, beta, dtype, device, nb))
            if min(shape) <= min_size or any(n % 2 for n in shape):
                break
            shape = tuple(n // 2 for n in shape)
            ldx = tuple(2 * h for h in ldx)
            la = None if la is None else _restrict(la, nb)
            lb = None if lb is None else [_coarsen_face_coef(lb[d], d, nb)
                                          for d in range(self.dim)]
            lm = _coarsen_metric(lm, self.dim)
        last = self.levels[-1]
        N = int(np.prod(last.shape))
        if N <= DIRECT_MAX:
            # the dense operator in one batched pass over the identity:
            # A[:, i] = L(e_i), homogeneous coarse BCs; one a problem of a
            # batch with its own coefficients
            eye = torch.eye(N, dtype=dtype, device=device).reshape((N,) + last.shape)
            e_g = _fill(_grow(eye, nb=1), bl, bh, nb=1)

            def dense(acoef_, bcoefs_):
                A = _apply(e_g, acoef_, bcoefs_, alpha, beta, last.dx, last.metric, nb=1,
                           cb=0).reshape(N, N).T
                if self.singular:
                    # pin the mean to remove the nullspace
                    A = A + torch.ones((N, N), dtype=dtype, device=device) / N
                return A

            if nb and (last.acoef is not None or last.bcoefs is not None):
                A = torch.stack([dense(None if last.acoef is None else last.acoef[i],
                                       None if last.bcoefs is None else
                                       [b[i] for b in last.bcoefs]) for i in range(batch)])
            else:
                A = dense(last.acoef, last.bcoefs)
            last.lu = torch.linalg.lu_factor(A)

    def fill(self, v, bvl=None, bvh=None):
        return _fill(_grow(v, self.nb), self.bl, self.bh, bvl, bvh, self.nb)

    def direct(self, r):
        """The coarsest level's exact solve of r (batched or not)."""
        last = self.levels[-1]
        LU, piv = last.lu
        if not self.nb:
            return torch.linalg.lu_solve(LU, piv, r.reshape(-1, 1)).reshape(last.shape)
        B = r.shape[0]
        if LU.dim() == 3:  # a dense operator a problem
            return torch.linalg.lu_solve(LU, piv, r.reshape(B, -1, 1)).reshape(r.shape)
        # one operator for the batch: the problems are its columns
        return torch.linalg.lu_solve(LU, piv, r.reshape(B, -1).T).T.reshape(r.shape)


@functools.lru_cache(maxsize=16)
def _cached_plan(shape, dx, bl, bh, alpha, beta, min_size, dtype, device, nb=0):
    return Plan(shape, dx, bl, bh, alpha, beta, min_size=min_size, dtype=dtype, device=device,
                nb=nb)


def solve(rhs, dx, *, acoef=None, bcoefs=None, alpha=0.0, beta=1.0,
          bc_lo=("periodic",) * 3, bc_hi=("periodic",) * 3,
          bc_vals_lo=None, bc_vals_hi=None,
          n_vcycles=30, nu1=2, nu2=2, coarse_sweeps=40,
          min_size=4, u0=None, rtol=None, atol=0.0,
          axis_names=None, metric=None, stats=None, nb=0, history=None):
    """Solve alpha*a*u - beta*div(b grad u) = rhs. Returns (u, residual_norm),
    the norm a 0-d tensor ([batch] with nb=1).

    With `rtol`, V-cycles run until ||res||_inf <= rtol*||rhs||_inf + atol or
    n_vcycles is reached (the reference MLMG semantics); otherwise exactly
    n_vcycles run. For the pure-Neumann/periodic Poisson problem the rhs's
    mean is removed (the reference subtracts the same `mass_offset`) and
    the returned u has zero mean. `stats`, a list, gets one (V-cycles,
    final residual norm) pair a solve, one a problem of a batch. `history`,
    a list, gets with `rtol` one (tolerances, [residual norms before the
    first V-cycle and after each]) pair a solve, each entry a list with
    one value a problem; the loop reads them anyway. `nb` = 1: a batch of
    problems along the leading axis (module docstring)."""
    if axis_names and any(n is not None for n in axis_names):
        raise NotImplementedError(
            "not ported yet: the distributed multigrid (axis_names; queue 1 item 13), "
            "see ROADMAP.md")
    dim = rhs.dim() - nb
    bl = tuple(_BC_CODE[b] for b in bc_lo[:dim])
    bh = tuple(_BC_CODE[b] for b in bc_hi[:dim])
    bvl = list(bc_vals_lo) if bc_vals_lo is not None else [None] * dim
    bvh = list(bc_vals_hi) if bc_vals_hi is not None else [None] * dim
    shape = tuple(rhs.shape[nb:])
    n_global = int(np.prod(shape))
    if acoef is None and bcoefs is None and metric is None:
        plan = _cached_plan(shape, tuple(float(h) for h in dx), bl, bh,
                            float(alpha), float(beta), min_size, rhs.dtype, rhs.device, nb)
    else:
        plan = Plan(shape, tuple(dx), bl, bh, alpha, beta, acoef, bcoefs, metric,
                    min_size, rhs.dtype, rhs.device, nb, rhs.shape[0] if nb else 1)
    levels = plan.levels
    singular = plan.singular
    red = tuple(range(nb, rhs.dim()))  # the axes of a problem's reductions

    def fill_at(k, v):
        # the finest level carries the boundary values; the coarser levels
        # solve correction equations with homogeneous BCs
        return plan.fill(v, bvl, bvh) if k == 0 else plan.fill(v)

    def residual(k, u, r):
        lv = levels[k]
        return r - _apply(fill_at(k, u), lv.acoef, lv.bcoefs, alpha, beta, lv.dx, lv.metric,
                          nb=nb)

    def smooth(k, u, r, n_sweeps):
        lv = levels[k]
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        for _ in range(n_sweeps):
            for mask in (lv.red, lv.black):
                u = u + torch.where(mask, residual(k, u, r) * lv.inv_diag, zero)
        return u

    def vcycle(k, u, r):
        lv = levels[k]
        if k == len(levels) - 1:
            if lv.lu is not None:
                return plan.direct(r)
            return smooth(k, u, r, coarse_sweeps)
        u = smooth(k, u, r, nu1)
        r_c = _restrict(residual(k, u, r), nb)
        e_c = vcycle(k + 1, torch.zeros_like(r_c), r_c)
        u = u + _prolong(e_c, plan.fill, nb)
        return smooth(k, u, r, nu2)

    def total(a):
        return torch.sum(a, dim=red, keepdim=True) if nb else torch.sum(a)

    def norm(a):
        return torch.amax(torch.abs(a), dim=red) if nb else torch.max(torch.abs(a))

    if singular:
        rhs = rhs - total(rhs) / n_global

    def de_mean(u):
        return u - total(u) / n_global if singular else u

    u = torch.zeros_like(rhs) if u0 is None else u0
    if rtol is None:
        for _ in range(n_vcycles):
            u = de_mean(vcycle(0, u, rhs))
        rnorm = norm(residual(0, u, rhs))
        if stats is not None:
            stats.extend((n_vcycles, r_) for r_ in rnorm.reshape(-1).tolist())
        return u, rnorm

    # run to tolerance (MLMG rel_eps): the bound in the working precision,
    # read with the first residual norm in one host sync; a problem of a
    # batch stops on its own test, its iterate and norm frozen after it
    rnorm = norm(residual(0, u, rhs))
    tol_t = rtol * norm(rhs) + atol
    r_host, tol = torch.stack([rnorm, tol_t]).reshape(2, -1).tolist()
    its = [0] * len(r_host)
    if history is not None:
        history.append((tol, [r_host]))
    live = [r_ > t_ for r_, t_ in zip(r_host, tol)]
    # one V-cycle of the live problems, in place on (u, rnorm); `keep`
    # holds the live flags (0-d without a batch)
    u, rnorm = u.clone(), rnorm.clone()
    keep = torch.tensor(live if nb else live[0], device=u.device)
    keep_u = keep.reshape((-1,) + (1,) * dim) if nb else keep

    def cycle():
        u_new = de_mean(vcycle(0, u, rhs))
        r_new = norm(residual(0, u_new, rhs))
        u.copy_(torch.where(keep_u, u_new, u))
        rnorm.copy_(torch.where(keep, r_new, rnorm))

    step = cycle
    it = 0
    while any(live) and it < n_vcycles:
        if nb:
            keep.copy_(torch.tensor(live, device="cpu"))
        if it == 1 and u.is_cuda:
            # the V-cycles past the first replay one CUDA graph: a V-cycle
            # is hundreds of small launches, host-bound eagerly; the
            # capture's warm-up runs this iteration
            step = capture(cycle, u.device, collect=False).replay
        else:
            step()
        it += 1
        r_host = rnorm.reshape(-1).tolist()
        if history is not None:
            history[-1][1].append(r_host)
        for i, on in enumerate(live):
            if on:
                its[i] = it
                live[i] = r_host[i] > tol[i]
    if stats is not None:
        stats.extend(zip(its, r_host))
    return u, rnorm


def poisson(rhs, dx, **kw):
    """Solve laplacian(u) = rhs (ABec L = -div grad, so the rhs is negated):
    the gravity entry point, del^2 phi = 4 pi G rho (reference
    `Gravity::solve_phi_with_mlmg`, Gravity.cpp:3465)."""
    return solve(-rhs, dx, alpha=0.0, beta=1.0, **kw)
