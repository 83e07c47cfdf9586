"""The port's AMR driver against the JAX package's, on the CPU, in 1D:
uniform flow through a static refined box, 1D Sod with regrids, and a
retry forced by a failure on the fine level after level 0 has stepped.
Float64 with jit disabled on the JAX side. Windows and masks must be equal;
each level's state agrees to rtol 1e-10 with an absolute floor of 1e-10
times the component's largest magnitude, as in tests/test_torch_driver.py;
a momentum's floor is at least 1e-10 sqrt(max rho x max rho E), the
momentum scale of the state, so that where a flow is at rest the
momentum's round-off is not held to itself. The helpers here serve the
other tests/test_torch_amr_*.py files too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import sod as jsod
from castro_tpu.problems.util import fill_from_prim as jfill

from castro_tpu_torch import convert
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.problems import sod
from castro_tpu_torch.problems.util import fill_from_prim

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _close(got, ref, what, rtol=RTOL):
    """A conserved state [NVAR, ...] against the reference (module doc)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    mag = np.abs(ref).reshape(ref.shape[0], -1).max(1)
    mom = np.sqrt(mag[0] * mag[4])  # URHO, UEDEN
    mag[1:4] = np.maximum(mag[1:4], mom)  # UMX, UMY, UMZ
    mag = mag.reshape((-1,) + (1,) * (ref.ndim - 1))
    np.testing.assert_array_less(np.abs(got - ref), rtol * (np.abs(ref) + mag) + 1e-300,
                                 err_msg=what)


def assert_same_hierarchy(port, jamr, rtol=RTOL, what=""):
    """Equal windows, masks and extra windows; close level states."""
    got, ref = convert.hierarchy_to_numpy(port), convert.hierarchy_to_numpy(jamr)
    for l in range(len(ref["u"])):
        gw, rw = got["window"][l], ref["window"][l]
        assert np.array_equal(gw[0], rw[0]) and gw[1] == rw[1], (what, l, gw, rw)
        assert np.array_equal(got["masks"][l], ref["masks"][l]), (what, "mask", l)
        _close(got["u"][l], ref["u"][l], f"{what} level {l}", rtol)
        assert len(got["extra"][l]) == len(ref["extra"][l]), (what, "extras", l)
        for k, (ge, re_) in enumerate(zip(got["extra"][l], ref["extra"][l])):
            assert np.array_equal(ge["ilo"], re_["ilo"]) and ge["shape"] == re_["shape"]
            assert np.array_equal(ge["mask"], re_["mask"]), (what, "extra mask", l, k)
            _close(ge["u"], re_["u"], f"{what} level {l} extra {k}", rtol)
    assert got["t"] == pytest.approx(ref["t"], rel=1e-14)


def step_both(port, jamr, n, regrid_int=0, dt=None):
    """n coarse steps in both packages with JAX's dt (its estimate unless
    `dt` is given) and regrids every regrid_int steps, as `run` orders
    them."""
    for _ in range(n):
        if regrid_int and jamr.step_count > 0 and jamr.step_count % regrid_int == 0:
            jamr.regrid()
            port.regrid()
        d = dt if dt is not None else jamr.estimate_dt()
        if dt is None:
            assert port.estimate_dt() == pytest.approx(d, rel=1e-12)
        jamr.advance(d)
        port.advance(d)
        jamr.step_count += 1
        port.step_count += 1
        jamr.dt = port.dt = d


def _uniform_params(mod, n=32):
    p = mod.make_params(n=n, dim=1)
    p = p.with_ns("amr", max_level=1, regrid_int=0)
    return p.with_ns("castro", lo_bc=(0,), hi_bc=(0,))  # periodic


def _box_tags(sim, u_int, level):
    x = sim.geom.cell_centers_1d(0, 0)
    return (x > 0.4) & (x < 0.6)


def test_uniform_flow_preserved():
    """Uniform advection through a static refined box stays uniform
    (fillpatch interpolation, subcycling, reflux, avgDown), as in JAX."""
    def jinit(sim, u):
        return jfill(sim, u, 1.0, (1.0, 0.0, 0.0), p=1.0)

    def init(sim, u):
        return fill_from_prim(sim, u, 1.0, (1.0, 0.0, 0.0), p=1.0)

    def jtag(sim, u_int, level):
        x = jnp.asarray(sim.geom.cell_centers_1d(0, 0))
        return (x > 0.4) & (x < 0.6)

    port = AmrSimulation(_uniform_params(sod), problem_init=init,
                         problem_tagging=_box_tags, device="cpu")
    port.init_data()
    with jax.disable_jit():
        jamr = JAmr(_uniform_params(jsod), problem_init=jinit, problem_tagging=jtag)
        jamr.init_data()
        assert int(port.masks[1].sum()) > 0
        assert_same_hierarchy(port, jamr, what="init")
        step_both(port, jamr, 5, dt=2e-3)
        assert_same_hierarchy(port, jamr, what="after 5 steps")
    u0, u1 = port.interior(0).numpy(), port.interior(1).numpy()
    m1 = port.masks[1].numpy()
    np.testing.assert_allclose(u0[0], 1.0, rtol=1e-11)
    np.testing.assert_allclose(u0[1], 1.0, rtol=1e-11)
    np.testing.assert_allclose(u1[0][m1], 1.0, rtol=1e-11)


def _sod_params(mod):
    p = mod.make_params(n=64, dim=1)
    p = p.with_ns("amr", max_level=1, regrid_int=2, n_error_buf=2,
                  refinement_indicators=("dens",))
    return p.replace(extra={"amr.dens.field": "density", "amr.dens.relative_gradient": 0.05})


def test_sod_regrid_matches_jax_and_conserves_mass():
    """1D Sod n=64, max_level=1, regrid_int=2: six coarse steps with two
    regrids (the window grows); each level against JAX, and the composite
    mass conserved to 1e-11 (no inflow)."""
    port = AmrSimulation(_sod_params(sod), problem_init=sod.problem_init, device="cpu")
    port.init_data()
    with jax.disable_jit():
        jamr = JAmr(_sod_params(jsod), problem_init=jsod.problem_init)
        jamr.init_data()
        assert_same_hierarchy(port, jamr, what="init")
        mass0 = float(port.composite_interior()[0].mean())
        windows = [port.window[1]]
        for k in range(3):
            step_both(port, jamr, 2, regrid_int=2)
            assert_same_hierarchy(port, jamr, what=f"after {2 * k + 2} steps")
            windows.append(port.window[1])
    assert len({w[1] for w in windows}) > 1, windows  # a regrid resized the window
    mass1 = float(port.composite_interior()[0].mean())
    assert mass1 == pytest.approx(mass0, rel=1e-11)


def _spike_params(mod):
    p = _uniform_params(mod, n=32)
    return p.with_ns("castro", lo_bc=(0,), hi_bc=(0,), small_dens=1e-8)


def test_retry_after_a_fine_level_failure():
    """A dt that level 0 takes but the fine level cannot (a velocity spike
    that only the fine cells resolve drives its Courant number above 1):
    the fine step fails after level 0 has stepped and the hierarchy is
    restored and subcycled, in both packages alike."""
    dx0 = 1.0 / 32
    xs = 0.5 + dx0 / 4  # a fine cell centre, a quarter coarse cell off the coarse centres
    w = dx0 / 4

    def jinit(sim, u):
        x = sim.geom.cell_centers(0, sim.ng)
        return jfill(sim, u, 1.0, (0.1 + 3.0 * jnp.exp(-((x - xs) / w) ** 2), 0.0, 0.0), p=1.0)

    def init(sim, u):
        x = sim.geom.cell_centers(0, sim.ng)
        return fill_from_prim(sim, u, 1.0, (0.1 + 3.0 * torch.exp(-((x - xs) / w) ** 2), 0.0, 0.0),
                              p=1.0)

    def jtag(sim, u_int, level):
        x = jnp.asarray(sim.geom.cell_centers_1d(0, 0))
        return (x > 0.4) & (x < 0.6)

    port = AmrSimulation(_spike_params(sod), problem_init=init,
                         problem_tagging=_box_tags, device="cpu")
    port.init_data()
    failures = []
    check = port._check

    def recording_check(out, what):
        try:
            check(out, what)
        except RuntimeError:
            failures.append(what)
            raise

    port._check = recording_check
    with jax.disable_jit():
        jamr = JAmr(_spike_params(jsod), problem_init=jinit, problem_tagging=jtag)
        jamr.init_data()
        assert_same_hierarchy(port, jamr, what="init")
        cfl = port.params.castro.cfl
        dt0 = float(port.sim0._estdt_impl(port.u[0])) / cfl
        dt1 = 2 * float(port.sims[1]._estdt_impl(port.u[1])) / cfl
        assert dt1 < 0.8 * dt0, (dt0, dt1)
        dt = 0.5 * (dt0 + dt1)  # level 0's Courant number < 1, level 1's > 1
        step_both(port, jamr, 1, dt=dt)
        assert_same_hierarchy(port, jamr, what="after the retried step")
    assert failures and all("level 1" in f for f in failures), failures
    assert port.num_zones_advanced == jamr.num_zones_advanced > port._count_zones(0)
