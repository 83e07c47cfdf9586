"""Batched stiff ODE integrator for reaction networks (counterpart of
`castro_tpu/integrators/stiff.py`; it replaces the per-zone VODE
integrator the reference calls through `burner(burn_state, dt)`,
`Source/reactions/Castro_react.cpp:123`).

Every zone advances through the same modified Rosenbrock pair (Shampine &
Reichelt's ode23s: L-stable order 2 with a 3rd-order error estimate; one
Jacobian and one LU shared by three solves a step) with its own adaptive
step. The Jacobian is autodiff of the RHS, exact, with no hand-coded
network Jacobians. Where the JAX package vmaps `jax.jacfwd` of the
pointwise RHS over zones, the port runs the RHS, vectorized over zones,
once with autograd and takes one backward pass batched over the rows:
forward mode (`torch.func.jacfwd`, or dual numbers) costs 10-20x more a
step on the CPU, where an operation between a dual and a plain tensor
takes a Python decomposition. The EOS and networks take their max/min
with the JAX derivative at ties (`utils/tmath.py`). The step loop is a
host loop with the JAX package's `lax.while_loop` condition and body: at
most `max_substeps` iterations, while any zone has t < t_done = dt (1 -
100 eps); each iteration steps every zone of a chunk and keeps the step
where the zone is active. The zones are taken a chunk at a time (a zone's
steps depend on nothing but its own state), which bounds the memory of
the autograd graph. The body has fixed shapes and no host read, so on the
card it is captured once as a CUDA graph (a chunk shape, kept with the
burner: `utils/cuda_graph.py:GraphLoop`) and replayed; the host reads
only whether any zone is still active, one sync a substep. An eager
iteration is some 8e4 launches (the Helmholtz inversions of three RHS
evaluations and the Jacobian's backward pass). W is factored in torch ops
(`lu_factor_ops`), as the batched factorization of torch.linalg cannot
be captured.

Burn state: y = [X_0..X_{nspec-1}, e]; density is constant over the burn
(the reference's burn_t). With `with_forcing` (the SDC couplings) the RHS
gains a piecewise-constant advective forcing, constant over the burn: it
adds to the RHS and leaves the Jacobian as it is; on the card it is one
more static input of the captured iteration, copied in before the replays."""

from __future__ import annotations

import torch

from castro_tpu_torch.utils.cuda_graph import GraphLoop
from castro_tpu_torch.utils.tmath import clip, vmax

D = 1.0 / (2.0 + 2.0**0.5)
E32 = 6.0 + 2.0**0.5

SAFETY = 0.9
GROW_MAX = 5.0
SHRINK_MIN = 0.1

# zones a chunk, on the CPU and on a card: bounds the memory of the
# Jacobian's autograd graph (some 4000 saved float64 intermediates a zone
# with the Helmholtz EOS's 12 Newton iterations: 16 GB at 2^19 zones)
CHUNK = 1 << 17
CHUNK_CUDA = 1 << 19


def lu_factor_ops(W):
    """LU factorization with partial pivoting of a batch of small matrices
    W [nz, n, n] in torch ops, in LAPACK's form (L below the diagonal, U on
    and above it, 1-based pivots) as torch.linalg.lu_factor gives it, for
    torch.linalg.lu_solve: the unblocked algorithm, a column at a time.
    It captures into a CUDA graph, where the batched factorization of
    torch.linalg does not."""
    A = W.clone()
    nz, n, _ = A.shape
    piv = torch.empty((nz, n), dtype=torch.int32, device=A.device)
    piv[:, n - 1] = n
    for k in range(n - 1):
        p = torch.argmax(torch.abs(A[:, k:, k]), dim=1) + k
        piv[:, k] = (p + 1).to(torch.int32)
        idx = p[:, None, None].expand(nz, 1, n)
        row_k = A[:, k:k + 1, :].clone()
        row_p = torch.gather(A, 1, idx)
        A.scatter_(1, idx, row_k)
        A[:, k:k + 1, :] = row_p
        A[:, k + 1:, k] = A[:, k + 1:, k] / A[:, k, k][:, None]
        A[:, k + 1:, k + 1:] = A[:, k + 1:, k + 1:] - A[:, k + 1:, k, None] * A[:, k, None, k + 1:]
    return A, piv


class BurnStats:
    """What the last burn did: the loop's iterations (the most any zone
    took) and each zone's iteration count (flattened)."""

    def __init__(self):
        self.iterations = 0
        self.zone_steps = None


def make_burner(network, eos, rtol=1e-6, atol_x=1e-8, atol_e=1e-6, max_substeps=1024,
                with_forcing=False):
    """Returns burn(rho, T, xn, e, dt[, xdot_force, edot_force]) -> (xn_new,
    e_new, fail), all arrays of the grid's shape (xn and xdot_force [nspec,
    ...]); `burn.stats` holds the last call's BurnStats,
    `burn.rosenbrock_step` the step itself. `with_forcing`: the burn
    integrates dX/dt = xdot + xdot_force, de/dt = edot + edot_force (the
    simplified-SDC coupling, reference `Castro_react.cpp:239-480`)."""
    nspec = network.nspec
    ny = nspec + 1

    def rhs_v(y, rho):
        """The RHS of a batch of zones (y: [nz, ny], rho: [nz]) -> [nz, ny]."""
        xn = clip(y[:, :nspec].T, 0.0, 1.0)
        e = vmax(y[:, nspec], 1e-30)
        es = eos.re(rho=rho, e=e, xn=xn)
        xdot, edot = network.rhs(rho, es.T, xn, e)
        return torch.cat([xdot, edot[None]], dim=0).T

    def jac_v(y, rho):
        """d rhs / d y of each zone, [nz, ny, ny], by reverse-mode autodiff:
        one pass over the batch, then one backward pass batched over the ny
        rows (the zones are independent, so row i of every zone's Jacobian
        is the gradient of the sum over zones of output i). In float64
        always: in float32
        the backward pass of a torch.where multiplies the zero gradient of
        its unselected branch by that branch's derivative, which
        overflows (an underflowed rate's inverse) and makes NaN, where the
        JAX package's forward mode never forms the product."""
        with torch.enable_grad():
            yg = y.detach().to(torch.float64).requires_grad_(True)
            f = rhs_v(yg, rho.to(torch.float64))
            # one unit gradient of output i over every zone, for each row i
            onehot = torch.eye(ny, dtype=f.dtype, device=f.device)[:, None, :].expand(
                ny, f.shape[0], ny)
            (rows,) = torch.autograd.grad(f, yg, onehot, is_grads_batched=True,
                                          allow_unused=True, materialize_grads=True)
        return rows.permute(1, 0, 2).to(y.dtype)

    def rosenbrock_step(y, rho, h, force=None):
        """One ode23s step, batched: y [nz, ny], rho [nz], h [nz], the
        forcing [nz, ny] or None. Returns (y_new, err)."""

        def rhs_f(y_):
            f = rhs_v(y_, rho)
            return f if force is None else f + force

        f0 = rhs_f(y)
        J = jac_v(y, rho)
        eye = torch.eye(ny, dtype=y.dtype, device=y.device)
        W = eye[None] - (h * D)[:, None, None] * J
        LU, piv = lu_factor_ops(W)

        def solve(b):
            return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]

        k1 = solve(f0)
        f1 = rhs_f(y + 0.5 * h[:, None] * k1)
        k2 = solve(f1 - k1) + k1
        y_new = y + h[:, None] * k2
        f2 = rhs_f(y_new)
        k3 = solve(f2 - E32 * (k2 - f1) - 2.0 * (k1 - f0))
        err = (h / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)
        return y_new, err

    def masked_iteration(st):
        """One iteration of the JAX package's loop body over every zone of a
        chunk, in place on st = [y, rho, t, h, steps, active, dt, t_done
        (, force)]: the step is kept where the zone was active, and `active`
        is recomputed for the next iteration."""
        y, rho, t, h, steps, active, dt_t, t_done_t = st[:8]
        h_eff = torch.where(active, torch.minimum(h, dt_t - t), h)
        y_new, err = rosenbrock_step(y, rho, h_eff, st[8] if len(st) > 8 else None)
        scale = atol_x + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        scale_e = atol_e + rtol * torch.maximum(torch.abs(y[:, nspec]), torch.abs(y_new[:, nspec]))
        scale = torch.cat([scale[:, :nspec], scale_e[:, None]], dim=1)
        enorm = torch.amax(torch.abs(err) / scale, dim=1)
        ok = (enorm <= 1.0) & torch.all(torch.isfinite(y_new), dim=1)
        take = ok & active
        fac = SAFETY * torch.where(enorm > 0, enorm ** (-1.0 / 3.0),
                                   torch.full_like(enorm, GROW_MAX))
        fac = clip(fac, SHRINK_MIN, GROW_MAX)
        fac = torch.where(torch.isfinite(enorm), fac, torch.full_like(fac, SHRINK_MIN))
        y.copy_(torch.where(take[:, None], y_new, y))
        t_new = torch.where(take, t + h_eff, t)
        h.copy_(torch.where(active, h_eff * fac, h))
        steps.add_(active.to(steps.dtype))
        t.copy_(t_new)
        active.copy_(t_new < t_done_t)

    loop = GraphLoop(masked_iteration)

    def integrate(y0, rho, dt, t_done, force=None):
        """Advance the zones of one chunk; returns (y, t, steps, iterations)."""
        t = torch.zeros_like(rho)
        st = [y0, rho, t, torch.full_like(t, dt / 16.0),
              torch.zeros(rho.shape, dtype=torch.int32, device=rho.device), t < t_done,
              torch.full((), dt, dtype=t.dtype, device=t.device),
              torch.full((), t_done, dtype=t.dtype, device=t.device)]
        if force is not None:
            st.append(force)
        it, st = loop(st, max_substeps, more=lambda s: bool(s[5].any()),  # one sync a substep
                      graph=burn.use_graph)
        return st[0].clone(), st[2].clone(), st[4].clone(), it

    def burn(rho, T, xn, e, dt, xdot_force=None, edot_force=None):
        shape = rho.shape
        rho_f = rho.reshape(-1)
        y0 = torch.cat([xn.reshape(nspec, -1), e.reshape(1, -1)], dim=0).T.contiguous()
        force = None
        if with_forcing:
            force = torch.cat([xdot_force.reshape(nspec, -1), edot_force.reshape(1, -1)],
                              dim=0).T.contiguous()
        # completion threshold in units of the working dtype's epsilon
        eps = float(torch.finfo(y0.dtype).eps)
        t_done = dt * (1.0 - 100.0 * eps)
        ys, ts, ss, its = [], [], [], []
        n = CHUNK_CUDA if y0.is_cuda else CHUNK
        for lo in range(0, y0.shape[0], n):
            y, t, s, it = integrate(y0[lo:lo + n].clone(), rho_f[lo:lo + n], dt, t_done,
                                    None if force is None else force[lo:lo + n])
            ys.append(y), ts.append(t), ss.append(s), its.append(it)
        y, t = torch.cat(ys), torch.cat(ts)
        burn.stats.iterations = max(its) if its else 0
        burn.stats.zone_steps = torch.cat(ss)
        fail = (t < t_done).reshape(shape)

        xn_new = clip(y[:, :nspec].T.reshape((nspec,) + shape), 0.0, 1.0)
        ssum = torch.sum(xn_new, dim=0)
        xn_new = xn_new / vmax(ssum, 1e-30)[None]
        e_new = y[:, nspec].reshape(shape)
        return xn_new, e_new, fail

    burn.stats = BurnStats()
    burn.rosenbrock_step = rosenbrock_step
    burn.use_graph = True  # False: the card runs the iteration eagerly (its tests)
    return burn
