"""The gray implicit update where its solves run their cap of 40 V-cycles:
the port against the JAX package on the CPU, float64.

The 3D gray pulse of `chip_smoke.py`'s path M (kappa_r 1e4, no emission,
periodic) at 32^3 with dt 16 x 2e-3, so that beta b / dx^2 is what it is at
128^3 with dt 2e-3. There the residual of the 1e-10 * max|rhs| test is
below what the operator's round-off lets the computed residual reach: it
falls tenfold a V-cycle, then stays flat, above the tolerance, in both
packages, and both return the same Er to round-off."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_radiation import (JParams, Params, close, fld, geometry_from_params, jfld,
                                  jgeom, jlayout, jmg, layout_from_params, make_jit_solve,
                                  rad_params)

N, DT = 32, 16 * 2e-3
CAP = 40  # the gray update's n_vcycles


def test_gray_update_at_the_vcycle_cap(monkeypatch):
    rad = dict(const_kappa_p=0.0, const_kappa_r=1e4, limiter=2)
    jp, tp = (rad_params(P, 3, N, **rad).with_ns("castro", lo_bc=(0,) * 3, hi_bc=(0,) * 3)
              for P in (JParams, Params))
    jr = jfld.FLDRadiation(jp, jgeom(jp, jnp.float64), jlayout(jp))
    tr = fld.FLDRadiation(tp, geometry_from_params(tp, torch.float64, "cpu"),
                          layout_from_params(tp))
    x = (np.arange(N) + 0.5) / N
    r2 = sum(np.meshgrid(*(((x - 0.5) ** 2,) * 3), indexing="ij"))
    Er = 1e-6 + 5.0 * np.exp(-r2 / 0.02)
    one = np.ones((N,) * 3)
    matter = (one, 1e8 * one, one, 1e8 * one)  # rho, e, T, cv

    # the JAX solves: their final residual norm against their tolerance
    jsolve, jrecs = make_jit_solve(), []

    def recorded(rhs, dx, **kw):
        u, rnorm = jsolve(rhs, dx, **kw)
        jrecs.append((float(rnorm), kw["rtol"] * float(jnp.max(jnp.abs(rhs)))))
        return u, rnorm

    monkeypatch.setattr(jmg, "solve", recorded)
    with jax.disable_jit():
        ref = jr.gray_update(*(jnp.asarray(a) for a in (Er,) + matter), DT)
    tr.solve_history = []
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = tr.gray_update(*(torch.as_tensor(a) for a in (Er,) + matter), DT)
    finally:
        torch.set_num_threads(n_threads)

    n_solves = tr.outer_iters
    # JAX's while_loop stops on rnorm <= tol or at its cap: every solve
    # returns above its tolerance, so each ran the cap
    assert len(jrecs) == n_solves and all(r > t for r, t in jrecs), jrecs
    assert len(tr.solve_stats) == n_solves and all(c == CAP for c, _ in tr.solve_stats)
    assert len(tr.solve_history) == n_solves
    for (tol,), hist in tr.solve_history:
        res = [h[0] for h in hist]
        assert len(res) == CAP + 1
        # converging tenfold a V-cycle at first, then a plateau above the
        # tolerance over the last half of the cycles
        assert res[8] < 1e-7 * res[0]
        late = res[CAP // 2:]
        assert min(late) > tol and max(late) < 3.0 * min(late), (tol, res)
    for k, name in enumerate(("Er", "e", "T")):
        close(got[k], ref[k], what=name)
