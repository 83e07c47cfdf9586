"""True SDC of the PyTorch port (`sdc/__init__.py`: TrueSDC2, TrueSDC4 on
Gauss-Lobatto nodes, TrueSDC4Radau) against the JAX package on the CPU,
and on its own:

- one step of each integrator on the acoustic pulse (1D n = 32, 2D 16^2)
  from the JAX initial state, the state and the time-averaged face fluxes
  of `keep_fluxes` against the JAX package's `sdc.advance`, which its
  `Simulation._jit_sdc_step` jits (run here op by op), float64 at rtol
  1e-10 with a floor of 1e-10 of each component's largest magnitude,
  interiors only;
- the port's own self-convergence on the 1D pulse, as
  tests/test_sdc4.py:36-70 measures the JAX package's: SDC-4 (Lobatto and
  Radau) above order 3.2, SDC-2 between 1.5 and 3.2;
- the step's structure: a 3D step solves 78 (Lobatto), 102 (Radau) and 9
  (SDC-2) Riemann problems through the cmpflx wrapper, and `advance`'s
  retry ladder acts on the SDC step's status.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import acoustic_pulse as jap
from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import fourth_order as t4
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.problems import acoustic_pulse as ap

jax.config.update("jax_enable_x64", True)

# name -> (sdc_order, sdc_quadrature)
INTEGRATORS = {"sdc2": (2, 0), "sdc4-lobatto": (4, 0), "sdc4-radau": (4, 1)}
SIZES = {1: 32, 2: 16}
DT = 2e-3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(mod, n, dim, order, quadrature, **castro):
    return mod.make_params(n=n, dim=dim).with_ns(
        "castro", time_integration_method=2, sdc_order=order, sdc_quadrature=quadrature,
        **castro)


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1).reshape((-1,) + (1,) * (ref.ndim - 1))
    np.testing.assert_array_less(np.abs(got - ref), 1e-10 * (np.abs(ref) + scale) + 1e-300,
                                 err_msg=what)


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("name", list(INTEGRATORS))
def test_step_matches_jax(name, dim):
    order, quad = INTEGRATORS[name]
    n = SIZES[dim]
    js = JSim(_params(jap, n, dim, order, quad), problem_init=jap.problem_init)
    js.init_data()
    with jax.disable_jit():
        ju, jfail, jfl = js.sdc.advance(js.u, DT, 0.0, keep_fluxes=True)
    sim = Simulation(_params(ap, n, dim, order, quad), problem_init=ap.problem_init,
                     device="cpu")
    assert type(sim.sdc).__name__ == type(js.sdc).__name__
    assert sim.sdc.n_iters == js.sdc.n_iters
    sim.init_data()
    ng = sim.ng
    inner = (slice(None),) + (slice(ng, -ng),) * dim
    _close(sim.interior(), np.asarray(js.u)[inner], "init")
    u0 = convert.state_from_numpy(np.asarray(js.u), sim.layout, "cpu", sim.dtype)
    u1, fail, fl = sim.sdc.advance(u0, DT, 0.0, keep_fluxes=True)
    assert not bool(fail) and not bool(jfail)
    _close(sim.interior(u1), np.asarray(ju)[inner], "state")
    for d in range(dim):
        _close(fl[d][inner], np.asarray(jfl[d])[inner], f"fluxes d={d}")
    # the driver's step: the same state, its checks, and the interior fluxes
    out = sim._sdc_step(u0, DT, 0.0, keep_fluxes=True)
    assert torch.equal(out[0], u1) and float(out[1]) > 0.0 and not bool(out[2])
    assert [tuple(f.shape[1:]) for f in out[4]] == [
        tuple(n + (k == d) for k in range(dim)) for d in range(dim)]


def _run(n, order, quadrature=0, nsteps_base=8, dim=1):
    sim = Simulation(_params(ap, n, dim, order, quadrature, use_retry=0),
                     problem_init=ap.problem_init, device="cpu")
    sim.init_data()
    if order >= 4:
        # the 4th-order scheme evolves cell averages: convert the pointwise
        # initial values (else the initial condition caps the order at 2)
        sim.u = sim._clean_fill_impl(t4.cell_center_to_avg(sim.u, dim))
    nsteps = nsteps_base * (n // 16)
    dt = 0.24 / 1.8 / n  # dt ~ dx: the time and space orders together
    u = sim.u
    for _ in range(nsteps):
        u, fail = sim.sdc.advance(u, dt, 0.0)
        assert not bool(fail)
    return sim.interior(u).numpy(), nsteps * dt


def _self_convergence(order, quadrature=0):
    (u16, t16), (u32, t32), (u64, t64) = (_run(n, order, quadrature) for n in (16, 32, 64))
    assert abs(t16 - t32) < 1e-12 and abs(t32 - t64) < 1e-12

    def coarsen(a):
        return a.reshape(a.shape[0], -1, 2).mean(axis=2)

    e_coarse = np.abs(u16 - coarsen(u32)).mean()
    e_fine = np.abs(u32 - coarsen(u64)).mean()
    return np.log2(e_coarse / e_fine)


@pytest.mark.parametrize("name", list(INTEGRATORS))
def test_self_convergence(name):
    order, quad = INTEGRATORS[name]
    rate = _self_convergence(order, quad)
    if order == 4:
        assert rate > 3.2, f"{name} rate {rate}"
    else:
        assert 1.5 < rate < 3.2, f"{name} rate {rate}"


@pytest.mark.parametrize("name, solves", [("sdc2", 9), ("sdc4-lobatto", 78),
                                          ("sdc4-radau", 102)])
def test_riemann_solves_a_3d_step(name, solves, monkeypatch):
    """The MOL evaluations of a 3D step (3, 13 and 17) and their solves
    through the cmpflx wrapper (one a direction at order 2, two at order
    4), with clean_fill once a node update; the wrappers run their plain
    versions on the CPU, so their calls are counted here."""
    order, quad = INTEGRATORS[name]
    calls = {"cmpflx": 0, "clean_fill": 0}
    for kname in calls:
        fn = getattr(K, kname)

        def counted(*a, _fn=fn, _k=kname, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(K, kname, counted)
    sim = Simulation(_params(ap, 8, 3, order, quad), problem_init=ap.problem_init,
                     device="cpu")
    sim.init_data()
    calls.update(cmpflx=0, clean_fill=0)
    u, status = sim.try_step(1e-3)
    assert status.success
    n_iters = sim.sdc.n_iters
    nodes = {"sdc2": 1, "sdc4-lobatto": 2, "sdc4-radau": 3}[name]
    assert calls == {"cmpflx": solves,
                     "clean_fill": nodes * n_iters + (1 if name == "sdc2" else 0)}


def test_retry_acts_on_the_sdc_status(monkeypatch):
    """A failed SDC step (here the burn's flag, forced on the first two
    tries) reports burn_fail, and in `advance` takes the retry ladder: the
    step is redone in substeps of retry_subcycle_factor dt from the saved
    state."""
    sim = Simulation(_params(ap, 16, 1, 2, 0), problem_init=ap.problem_init, device="cpu")
    sim.init_data()
    advance = sim.sdc.advance
    tries = []

    def flaky(u, dt, t, keep_fluxes=False, ctx=None):
        out = advance(u, dt, t, keep_fluxes=keep_fluxes, ctx=ctx)
        tries.append(dt)
        if len(tries) <= 2:
            out = (out[0], torch.ones((), dtype=torch.bool)) + tuple(out[2:])
        return out

    monkeypatch.setattr(sim.sdc, "advance", flaky)
    u_before = sim.u.clone()
    u1, status = sim.try_step(1e-3)
    assert status.burn_fail and not status.success and not status.has_nan
    assert torch.equal(sim.u, u_before)
    taken = sim.advance(1e-3)
    c = sim.params.castro
    assert taken == 1e-3 and sim.t == pytest.approx(1e-3)
    assert len(tries) == 2 + round(1 / c.retry_subcycle_factor)
    assert tries[2] == pytest.approx(1e-3 * c.retry_subcycle_factor)
