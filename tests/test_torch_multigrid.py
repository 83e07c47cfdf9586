"""The port's multigrid (`castro_tpu_torch/solvers/multigrid.py`) against the
JAX package's (`castro_tpu/solvers/multigrid.py`), float64 on the CPU:
tests/test_multigrid.py's five setups (the 3D and ABec grids halved)
through both packages' `solve` / `poisson`, a singular periodic case whose coarsest level is solved
directly, a run to tolerance (the same V-cycle count and residual norm),
and a coarsest level above the direct solve's 1024 cells (the 40 sweeps).

Tolerance: 1e-10 of the solution's largest magnitude (the same arithmetic
in another order); the residual norms within 1e-6 relative plus 1e-12 of
max|rhs| (a converged float64 residual sits at the rounding floor of the
rhs, where the two orders of operation differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from castro_tpu.solvers import multigrid as jmg
from castro_tpu_torch.solvers import multigrid as tmg

TOL = 1e-10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _agree(uj, rj, ut, rt, rhs):
    uj, ut = np.asarray(uj), ut.numpy()
    scale = np.abs(uj).max()
    err = np.abs(ut - uj).max() / scale
    assert err <= TOL, err
    rj, rt = float(rj), float(rt)
    assert abs(rt - rj) <= 1e-6 * abs(rj) + 1e-12 * np.abs(rhs).max(), (rt, rj)


def _grid(n, dim):
    x = (np.arange(n) + 0.5) / n
    return np.meshgrid(*([x] * dim), indexing="ij")


def _setups():
    """name -> (entry, rhs, dx, kwargs) of tests/test_multigrid.py."""
    k = 2 * np.pi
    out = {}
    X, Y = _grid(64, 2)
    ue = np.sin(k * X) * np.sin(2 * k * Y)
    out["periodic_2d"] = ("poisson", -(k**2 + (2 * k) ** 2) * ue, (1 / 64,) * 2,
                          dict(bc_lo=("periodic",) * 2, bc_hi=("periodic",) * 2, n_vcycles=12))
    X, Y, Z = _grid(16, 3)
    kp = np.pi
    ue = np.sin(kp * X) * np.sin(kp * Y) * np.sin(kp * Z)
    out["dirichlet_3d"] = ("poisson", -3 * kp**2 * ue, (1 / 16,) * 3,
                           dict(bc_lo=("dirichlet",) * 3, bc_hi=("dirichlet",) * 3,
                                n_vcycles=12))
    out["inhomogeneous_1d"] = ("poisson", np.zeros(64), (1 / 64,),
                               dict(bc_lo=("dirichlet",), bc_hi=("dirichlet",),
                                    bc_vals_lo=[1.0], bc_vals_hi=[3.0], n_vcycles=12))
    X, Y = _grid(32, 2)
    ue = np.cos(k * X) * np.cos(k * Y)
    a = 1.0 + 0.5 * np.sin(k * X) * np.sin(k * Y)
    out["abec_2d"] = ("solve", 2.0 * a * ue + 0.5 * 2 * k**2 * ue, (1 / 32,) * 2,
                      dict(acoef=a, bcoefs=[np.ones((33, 32)), np.ones((32, 33))], alpha=2.0,
                           beta=0.5, bc_lo=("periodic",) * 2, bc_hi=("periodic",) * 2,
                           n_vcycles=12))
    X, Y = _grid(32, 2)
    out["order_2d_n32"] = ("poisson", -2 * k**2 * np.sin(k * X) * np.sin(k * Y), (1 / 32,) * 2,
                           dict(bc_lo=("periodic",) * 2, bc_hi=("periodic",) * 2, n_vcycles=14))
    return out


SETUPS = _setups()


def _run(mod, conv, entry, rhs, dx, kw):
    kw = dict(kw)
    for key in ("acoef",):
        if key in kw:
            kw[key] = conv(kw[key])
    if "bcoefs" in kw:
        kw["bcoefs"] = [conv(b) for b in kw["bcoefs"]]
    return getattr(mod, entry)(conv(rhs), dx, **kw)


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_multigrid_setups_match_jax(name):
    entry, rhs, dx, kw = SETUPS[name]
    uj, rj = _run(jmg, jnp.asarray, entry, rhs, dx, kw)
    ut, rt = _run(tmg, _t, entry, rhs, dx, kw)
    _agree(uj, rj, ut, rt, rhs)


def test_singular_periodic_coarse_direct():
    """A periodic Poisson problem with a non-zero-mean rhs (the singular
    case: mean removal, the pinned dense operator on the 4 x 4 x 4 bottom)
    in 3D, and the port's plan solves its bottom directly."""
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((16, 16, 16)) + 0.3
    kw = dict(bc_lo=("periodic",) * 3, bc_hi=("periodic",) * 3, n_vcycles=6)
    uj, rj = jmg.poisson(jnp.asarray(rhs), (0.1, 0.2, 0.15), **kw)
    ut, rt = tmg.poisson(_t(rhs), (0.1, 0.2, 0.15), **kw)
    _agree(uj, rj, ut, rt, rhs)
    plan = tmg._cached_plan((16, 16, 16), (0.1, 0.2, 0.15), (0,) * 3, (0,) * 3, 0.0, 1.0, 4,
                            torch.float64, torch.device("cpu"))
    assert plan.singular and [lv.shape for lv in plan.levels][-1] == (4, 4, 4)
    assert plan.levels[-1].lu is not None
    assert abs(float(ut.sum())) < 1e-9 * float(ut.abs().max())


def test_run_to_tolerance_counts_match():
    """With rtol the port's loop stops at the V-cycle where the JAX
    while_loop stops, k: JAX's residual after k fixed V-cycles is within
    rtol max|rhs| and after k - 1 it is not; the norms agree."""
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((16, 16, 16))
    dx = (1 / 16,) * 3
    vals_lo = [rng.standard_normal((1, 16, 16)), rng.standard_normal((16, 1, 16)),
               rng.standard_normal((16, 16, 1))]
    kw = dict(bc_lo=("dirichlet",) * 3, bc_hi=("dirichlet",) * 3)
    rtol = 1e-7
    stats = []
    ut, rt = tmg.poisson(_t(rhs), dx, bc_vals_lo=[_t(v) for v in vals_lo], n_vcycles=50,
                         rtol=rtol, stats=stats, **kw)
    uj, rj = jmg.poisson(jnp.asarray(rhs), dx, bc_vals_lo=[jnp.asarray(v) for v in vals_lo],
                         n_vcycles=50, rtol=rtol, **kw)
    _agree(uj, rj, ut, rt, rhs)
    (count, r_port), = stats
    assert r_port == float(rt) and 2 <= count < 50

    def jax_fixed(k):
        return float(jmg.poisson(jnp.asarray(rhs), dx, bc_vals_lo=[jnp.asarray(v) for v in vals_lo],
                                 n_vcycles=k, **kw)[1])

    tol = rtol * np.abs(rhs).max()
    assert jax_fixed(count) <= tol < jax_fixed(count - 1)


def test_large_bottom_smooths():
    """A 132 x 50 window coarsens to 66 x 25 = 1650 cells, past the direct
    solve's 1024 (as a 44 x 52 x 36 window's 11 x 13 x 9 = 1287): the bottom
    is 40 red-black sweeps, as in JAX."""
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((132, 50))
    kw = dict(bc_lo=("dirichlet",) * 2, bc_hi=("dirichlet",) * 2, n_vcycles=2)
    dx = (0.01,) * 2
    uj, rj = jmg.poisson(jnp.asarray(rhs), dx, **kw)
    ut, rt = tmg.poisson(_t(rhs), dx, **kw)
    _agree(uj, rj, ut, rt, rhs)
    plan = tmg._cached_plan((132, 50), dx, (1,) * 2, (1,) * 2, 0.0, 1.0, 4, torch.float64,
                            torch.device("cpu"))
    assert plan.levels[-1].shape == (66, 25) and plan.levels[-1].lu is None


def test_distributed_solve_raises():
    with pytest.raises(NotImplementedError, match="item 13"):
        tmg.solve(_t(np.zeros((8, 8))), (1.0, 1.0), axis_names=("x", None))


def test_fill_bc_and_apply_op_match_jax():
    """fill_bc with every BC code (periodic, Neumann, Robin with (A, G)
    planes, Dirichlet with face arrays) and apply_op in its ABec form with
    a curvilinear metric, on a random 2D array."""
    rng = np.random.default_rng(9)
    n0, n1 = 10, 12
    ug = rng.standard_normal((n0 + 2, n1 + 2))
    robin = (rng.uniform(0.5, 1.5, (1, n1)), rng.standard_normal((1, n1)))
    dir_hi = rng.standard_normal((n0, 1))
    codes_lo, codes_hi = (jmg.ROBIN, jmg.PERIODIC), (jmg.NEUMANN, jmg.PERIODIC)

    def fills(mod, conv):
        a = mod.fill_bc(conv(ug), codes_lo, codes_hi,
                        [tuple(conv(x) for x in robin), None], None)
        b = mod.fill_bc(conv(ug), (jmg.NEUMANN, jmg.DIRICHLET), (jmg.DIRICHLET, jmg.DIRICHLET),
                        None, [2.5, conv(dir_hi)])
        return a, b

    for gj, gt in zip(fills(jmg, jnp.asarray), fills(tmg, _t)):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-15, atol=0)
    a = rng.uniform(1.0, 2.0, (n0, n1))
    b = [rng.uniform(0.5, 1.5, (n0 + 1, n1)), rng.uniform(0.5, 1.5, (n0, n1 + 1))]
    r = (np.arange(n0 + 1) + 0.5) * 0.1
    metric = {"areas": [np.broadcast_to(r[:, None], (n0 + 1, n1)).copy(),
                        np.ones((n0, n1 + 1))],
              "vol": rng.uniform(0.5, 1.5, (n0, n1))}

    def op(mod, conv):
        m = {"areas": [conv(x) for x in metric["areas"]], "vol": conv(metric["vol"])}
        return mod.apply_op(conv(ug), conv(a), [conv(x) for x in b], 0.7, 1.3, (0.1, 0.2),
                            metric=m)

    np.testing.assert_allclose(op(tmg, _t).numpy(), np.asarray(op(jmg, jnp.asarray)),
                               rtol=1e-14, atol=1e-14)


def test_metric_solve_matches_jax():
    """solve with ABec coefficients and a curvilinear metric (the form
    radiation calls): coarsened metric and face coefficients on every level,
    Neumann and Dirichlet faces, to a tolerance."""
    rng = np.random.default_rng(13)
    n0, n1 = 16, 16
    rhs = rng.standard_normal((n0, n1))
    a = rng.uniform(1.0, 2.0, (n0, n1))
    b = [rng.uniform(0.5, 1.5, (n0 + 1, n1)), rng.uniform(0.5, 1.5, (n0, n1 + 1))]
    rf = np.arange(n0 + 1) / n0 + 0.05
    rc = 0.5 * (rf[1:] + rf[:-1])
    metric = {"areas": [np.broadcast_to(rf[:, None], (n0 + 1, n1)).copy(),
                        np.broadcast_to(rc[:, None], (n0, n1 + 1)).copy()],
              "vol": np.broadcast_to(rc[:, None], (n0, n1)).copy()}
    kw = dict(alpha=1.0, beta=0.8, bc_lo=("neumann", "dirichlet"),
              bc_hi=("dirichlet", "dirichlet"), n_vcycles=30, rtol=1e-10)

    def run(mod, conv):
        m = {"areas": [conv(x) for x in metric["areas"]], "vol": conv(metric["vol"])}
        return mod.solve(conv(rhs), (1 / n0, 1 / n1), acoef=conv(a),
                         bcoefs=[conv(x) for x in b], metric=m, **kw)

    uj, rj = run(jmg, jnp.asarray)
    ut, rt = run(tmg, _t)
    _agree(uj, rj, ut, rt, rhs)
