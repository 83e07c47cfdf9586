"""The radiation setups of the port (`problems/rad_*.py`, `su_olson.py`,
`science_extra.bwp_rad_*`) against the JAX package's: the initial state and
Er of each, then 2 steps (the port from its own initial state, the JAX
package from its), compared after each step. Here the operator-split 1D
spherical setups and the mixed-frame shock; the do_hydro=0 setups in
tests/test_torch_rad_setups_source.py; the multigroup setups and bwp-rad
in tests/test_torch_rad_setups_mg.py.

Sizes are cut (the setups' own defaults run on the card, chip_smoke.py
path M); shapes, opacities, BCs and the EOS are the setups'. The JAX side
runs `_jit_rad_step`, its multigrid solves jitted on their own inside it.
Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per component (the
momenta sharing their scale)."""

import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSim

from castro_tpu_torch.driver.sim import Simulation

from test_torch_radiation import _few_threads, close, jit_jax_solve  # noqa: F401


def setup_against_jax(jmod_params, tmod_params, jinit, tinit, jpost=None, tpost=None, steps=2,
                      dt=None, ill=None):
    """Init both packages' setups and compare; then, from the JAX initial
    state (converted), `steps` steps at its first CFL dt (or `dt`),
    compared after each. `ill(js)`: interior cells whose thermal state the
    init comparison leaves out, where the setup's formula amplifies the
    last bit of a transcendental function beyond any tolerance."""
    js = JSim(jmod_params, problem_init=jinit)
    js.init_data()
    ts = Simulation(tmod_params, problem_init=tinit, device="cpu")
    ts.init_data()
    for post, s_ in ((jpost, js), (tpost, ts)):
        if post is not None:
            post(s_)
    L = ts.layout
    vec = [(L.UMX, L.UMY, L.UMZ)]
    got, ref = ts.interior().numpy(), np.asarray(js.interior())
    if ill is not None:
        m = ill(js)
        assert (~m).sum() >= 2
        for c in (L.UEDEN, L.UEINT, L.UTEMP):
            got[c][m] = ref[c][m]
    close(got, ref, what="init u", vectors=vec)
    er_j, er_t = np.asarray(js.u_rad), ts.u_rad.numpy()
    if ill is not None:
        er_t[..., ill(js)] = er_j[..., ill(js)]
    close(er_t if er_t.ndim > L.dim else er_t[None],
          er_j if er_j.ndim > L.dim else er_j[None], what="init Er")
    ts.u = torch.tensor(np.asarray(js.u))
    ts.u_rad = torch.tensor(np.asarray(js.u_rad))
    dt = float(js.estimate_dt()) if dt is None else dt
    u, Er = js.u, js.u_rad
    for k in range(steps):
        u, Er, _, bad = js._jit_rad_step(u, Er, dt, k * dt)
        ts.u, ts.u_rad = ts._rad_step_impl(ts.u, ts.u_rad, dt, k * dt)[:2]
        assert not bool(bad)
        close(ts.interior(), np.asarray(js.interior(u)), what=f"u step {k + 1}", vectors=vec)
        er_j = np.asarray(Er)
        close(ts.u_rad if ts.u_rad.dim() > L.dim else ts.u_rad[None],
              er_j if er_j.ndim > L.dim else er_j[None], what=f"Er step {k + 1}")
    return js, ts


def _blast_tail(js):
    """RadBlastWave's mixing T^4 = f T1^4 + (1 - f) T0^4, f = (1 -
    tanh(x)) / 2, in both packages: outside the sphere 1 - tanh cancels,
    and the last bit of tanh (XLA's and libm's differ there by an ulp) is
    multiplied by T1^4 / T0^4 = 1e16; the cells where f (exactly, 1 / (1 +
    e^2x)) is below 1e-4, where fewer than 12 of its digits survive."""
    from castro_tpu.problems import rad_blast as jm

    g = js.geom
    r = np.asarray(g.cell_centers_1d(0, 0))
    x = (r - jm.DEFAULTS["r1"] * g.prob_hi[0]) / (0.5 * g.dx[0])
    return 1.0 / (1.0 + np.exp(np.minimum(2.0 * x, 700.0))) < 1e-4


@pytest.mark.parametrize("name", ["rad_blast", "rad_breakout"])
def test_spherical_split_setups(jit_jax_solve, name):
    import importlib

    jm = importlib.import_module(f"castro_tpu.problems.{name}")
    tm = importlib.import_module(f"castro_tpu_torch.problems.{name}")
    n = 32 if name == "rad_blast" else 64
    setup_against_jax(jm.make_params(n=n), tm.make_params(n=n), jm.problem_init,
                      tm.problem_init, ill=_blast_tail if name == "rad_blast" else None)


def test_rad_breakout_filter_prim(jit_jax_solve):
    """filter_prim_int=1: the Purser filter of the primitives and Er after
    a step, against the JAX package's `_filter_prim`."""
    from castro_tpu.problems import rad_breakout as jm
    from castro_tpu_torch.problems import rad_breakout as tm

    js, ts = setup_against_jax(jm.make_params(n=64), tm.make_params(n=64), jm.problem_init,
                               tm.problem_init, steps=0)
    js._filter_prim()
    ts._filter_prim()
    L = ts.layout
    close(ts.interior(), np.asarray(js.interior()), what="u", vectors=[(L.UMX, L.UMY, L.UMZ)])
    close(ts.u_rad, np.asarray(js.u_rad), what="Er")


def test_rad_shock(jit_jax_solve):
    from castro_tpu.problems import rad_shock as jm
    from castro_tpu_torch.problems import rad_shock as tm

    setup_against_jax(jm.make_params(mach=2, n=32), tm.make_params(mach=2, n=32),
                      jm.problem_init, tm.problem_init,
                      jpost=lambda s_: setattr(s_, "u_rad", jm.rad_init(s_)),
                      tpost=lambda s_: setattr(s_, "u_rad", tm.rad_init(s_)))
