"""The multigroup implicit update of the port against the JAX package's
(2D, 3D with AMR's Dirichlet window data, 2D RZ with a problem's
per-group boundary values; frequency-dependent opacities), and the batched
multigrid under it: each group of a batch stops on its own test, with the
iterate and V-cycle count of its own solve, as the JAX package's vmapped
while_loop freezes a converged group.

Inputs from a numpy seed; the JAX multigrid jitted
(tests/test_torch_radiation.py:make_jit_solve). Tolerance: float64 1e-10
|jax| + 1e-10 max|jax| per leading component.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from castro_tpu_torch.solvers import multigrid as mg

from test_torch_radiation import _few_threads, _matter, close, fld_pair, jit_jax_solve, t64  # noqa: F401


@pytest.mark.parametrize("case", ["2d", "3d-override", "rz-groupvals"])
def test_multigroup_update(jit_jax_solve, case):
    dim, n, coord = {"2d": (2, 16, 0), "3d-override": (3, 8, 0), "rz-groupvals": (2, 16, 1)}[case]
    kw = dict(ngroups=4, lowest_group_hz=1e13, highest_group_hz=1e16, const_kappa_p=3.0,
              kappa_p_exp_p=-0.5, const_kappa_r=20.0, kappa_r_exp_p=-0.3, limiter=2,
              outer_iters=2, lo_bc=(104, 101, 102), hi_bc=(102, 101, 102),
              lo_bcval=(1e-5, 1e-15, 0), hi_bcval=(0.0, 2e-15, 0))
    jr, tr = fld_pair(dim, n, coord=coord, **kw)
    if case == "rz-groupvals":
        vals = np.array([1e-16, 2e-16, 3e-16, 1e-17])
        jr.bc_group_vals_lo = jnp.asarray(vals)
        tr.bc_group_vals_lo = vals
    rng = np.random.default_rng(11)
    rho, T, cv, e, _ = _matter(jr, tr, dim, n, seed=9)
    Er = 1e-15 * rng.uniform(0.1, 2.0, (4,) + (n,) * dim)
    override = None
    if case == "3d-override":
        override = tuple(tuple(rng.uniform(1e-16, 1e-15, (4,) + tuple(1 if k == d else n
                                                                       for k in range(dim)))
                               for d in range(dim)) for _ in range(2))
    args_j = [jnp.asarray(a) for a in (Er, rho, e, T, cv)]
    ref = jr.multigroup_update(*args_j, 1e-3, jr.nugroup, jr.dnugroup, metric=jr.geom_metric(),
                               keep_flux=True, bc_override=None if override is None else
                               tuple(tuple(jnp.asarray(v) for v in side) for side in override))
    got = tr.multigroup_update(*(t64(a) for a in (Er, rho, e, T, cv)), 1e-3, tr.nugroup,
                               tr.dnugroup, metric=tr.geom_metric(), keep_flux=True,
                               bc_override=None if override is None else
                               tuple(tuple(t64(v) for v in side) for side in override))
    for k, name in enumerate(("Er", "e", "T")):
        close(got[k], ref[k], what=name)
    for d in range(dim):
        close(got[3][d], ref[3][d], what=f"flux {d}")
    # one (V-cycles, residual) entry a group a solve
    assert len(tr.solve_stats) == 4 * 2


def test_batched_solve_stops_each_problem_on_its_own():
    """The batched multigrid: each problem of a batch gets the iterate and
    V-cycle count of its own solve (the JAX package's vmapped while_loop
    freezes a converged element), not the slowest one's."""
    rng = np.random.default_rng(2)
    n = 32
    # the diffusion strength sets the convergence rate: the groups differ
    acoef = t64(np.stack([np.full((n, n), a) for a in (1.0, 1.0, 1.0)]))
    bco = [t64(np.stack([np.full(tuple(n + (k == d) for k in range(2)), b)
                         for b in (1e-4, 1e-2, 1.0)])) for d in range(2)]
    rhs = t64(rng.uniform(0.5, 1.5, (3, n, n)))
    kw = dict(alpha=1.0, beta=1.0, bc_lo=("neumann",) * 2, bc_hi=("dirichlet",) * 2,
              n_vcycles=15, rtol=1e-10)
    stats_b = []
    ub, rb = mg.solve(rhs, (1 / n, 1 / n), acoef=acoef, bcoefs=bco, stats=stats_b, nb=1, **kw)
    for g in range(3):
        stats_1 = []
        u1, r1 = mg.solve(rhs[g], (1 / n, 1 / n), acoef=acoef[g], bcoefs=[b[g] for b in bco],
                          stats=stats_1, **kw)
        assert stats_b[g][0] == stats_1[0][0]
        torch.testing.assert_close(ub[g], u1, rtol=1e-13, atol=0.0)
    counts = [c_ for c_, _ in stats_b]
    assert len(set(counts)) > 1, counts
