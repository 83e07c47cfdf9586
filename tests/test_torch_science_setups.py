"""The convecting and reacting setups of ROADMAP item 7 in the port against
the JAX package on the CPU, float64, at small sizes: each initial state
(the generators, the EOS inversions, the NSE distribution, the bubbles and
vortices) within 1e-10 relative, each component's largest magnitude as the
floor; then steps in the port with the checks the JAX package's own tests
make of the setup (tests/test_problem_coverage.py,
tests/test_reacting_coverage.py, tests/test_unit_and_science_coverage.py).
The JAX initialization runs with its EOS modes jitted
(tests/test_torch_hse_fills.py:jitted_eos).

The white-dwarf setups, the bubbles and celldet, which are also held step
for step against JAX, have their own files (test_torch_{wd_models,
subchandra,massive_star,wdmerger,star_grav,hse_adjust,bubbles_celldet}.py).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.problems import acoustic_pulse as j_ap
from castro_tpu.problems import convect as j_convect
from castro_tpu.problems import gravity_tests as j_gt
from castro_tpu.problems import reacting_tests as j_rt
from castro_tpu.problems import science_extra as j_se
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import acoustic_pulse as ap
from castro_tpu_torch.problems import convect, reacting_tests as rt, science_extra as se
from castro_tpu_torch.problems import gravity_tests as gt
from test_torch_hse_fills import jitted_eos

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def same_state(got, ref, rtol=RTOL, floor=1e-14, what="init"):
    """got within rtol |ref| + floor max|ref| of ref, per component."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1).reshape((-1,) + (1,) * (ref.ndim - 1))
    err = np.abs(got - ref) - (rtol * np.abs(ref) + floor * scale)
    assert err.max() <= 0.0, (what, np.unravel_index(np.argmax(err), err.shape))


def jax_eos_jitted(eos):
    """jitted_eos for Helmholtz (op by op a Helmholtz step takes minutes);
    the analytic EOSes run as they are."""
    return jitted_eos(eos) if type(eos).__name__ == "HelmholtzEos" else contextlib.nullcontext()


def init_pair(jparams, jinit, tparams, tinit, ext=None, jext=None, **kw):
    """(the JAX Simulation, the port's), both initialized on the CPU; the
    port's initial state held against the JAX one."""
    js = JSimulation(jparams, problem_init=jinit, **({"ext_src": jext} if jext else {}))
    with jax_eos_jitted(js.eos):
        js.init_data()
    sim = Simulation(tparams, problem_init=tinit, device="cpu",
                     **({"ext_src": ext} if ext else {}))
    sim.init_data()
    same_state(sim.u.numpy(), np.asarray(js.u))
    return js, sim


def run_port(sim, nsteps, dt=None, frac=0.5):
    """nsteps steps of the port from its state; every one must succeed."""
    u, t = sim.u, 0.0
    for _ in range(nsteps):
        d = dt if dt is not None else float(sim._estdt_impl(u)) * frac
        u, _, bad = sim._step_impl(u, d, t)
        assert not bool(bad)
        t += d
    ui = sim.interior(u).numpy()
    assert np.isfinite(ui).all()
    return ui


def step_pair(js, sim, u0, dt, rtol=1e-8, floor=1e-10, what="step"):
    """One step of the JAX package (its Helmholtz modes and its react
    jitted) and of the port from the same state u0 [grown grid, numpy],
    the port's interior held against JAX's: within rtol |jax| + floor
    max|jax| a component, the three momenta sharing the largest momentum
    magnitude as their floor and the species densities the largest
    density (a trace species, 1e-20 of the mass, is held to 1e-10 of the
    mass, as the burns hold mass fractions absolutely). Returns the port's
    new state."""
    L = sim.layout
    if js.reactor is not None:
        js.reactor.react = jax.jit(js.reactor.react)
    with jax_eos_jitted(js.eos):
        ju, _, bad = js._step_impl(jax.numpy.asarray(u0), dt, 0.0)
    tu, _, flag = sim._step_impl(torch.tensor(u0), dt, 0.0)
    assert not bool(bad) and not bool(flag)
    ref, got = np.asarray(js.interior(ju)), sim.interior(tu).numpy()
    scale = np.abs(ref).reshape(L.NVAR, -1).max(1)[:, None]
    mom = slice(L.UMX, L.UMZ + 1)
    scale[mom] = scale[mom].max()
    scale[L.UFS:L.UFS + L.nspec] = scale[L.URHO]
    scale = scale.reshape((-1,) + (1,) * (ref.ndim - 1))
    err = np.abs(got - ref) - (rtol * np.abs(ref) + floor * scale)
    assert err.max() <= 0.0, (what, np.unravel_index(np.argmax(err), err.shape))
    return tu


def test_reacting_convergence():
    js, sim = init_pair(j_rt.reacting_convergence_params(n=12), j_rt.reacting_convergence_init,
                        rt.reacting_convergence_params(n=12), rt.reacting_convergence_init)
    L = sim.layout
    u0 = sim.interior().numpy()
    T0 = u0[L.UTEMP]
    assert T0.max() > 1.3 * np.median(T0)
    ic = np.unravel_index(np.argmax(T0), T0.shape)
    assert u0[L.URHO][ic] > 1.2 * np.median(u0[L.URHO])
    ui = run_port(sim, 2)
    assert ui[L.UFS + 1].max() > u0[L.UFS + 1].max()  # C12 from the burn


def test_bubble_convergence():
    js, sim = init_pair(j_rt.bubble_convergence_params(n=16), j_rt.bubble_convergence_init,
                        rt.bubble_convergence_params(n=16), rt.bubble_convergence_init)
    L = sim.layout
    u0 = sim.interior().numpy()
    assert u0[L.UTEMP].max() > 1.5 * np.median(u0[L.UTEMP])
    ui = run_port(sim, 2)
    assert ui[L.UMY].max() > 0.0


def test_nse_test():
    js, sim = init_pair(j_rt.nse_test_params(n=16), j_rt.nse_test_init,
                        rt.nse_test_params(n=16), rt.nse_test_init)
    L = sim.layout
    names = sim.network.spec_names
    u0 = sim.interior().numpy()
    X = u0[L.UFS:L.UFS + L.nspec] / u0[L.URHO][None]
    heavy = sum(X[k] for k, nm in enumerate(names) if nm in ("Ni56", "Fe52", "Fe54", "Cr48"))
    assert heavy.max() > 0.3
    ihe = names.index("He4")
    assert X[ihe][len(X[ihe]) // 2] > X[ihe][0]
    sim.reactor = None  # the burn at 6e9 K is the NSE bypass's test (test_torch_nse.py)
    run_port(sim, 2)


def test_toy_convect():
    js, sim = init_pair(j_convect.toy_convect_params(n=(8, 16)), j_convect.toy_convect_init,
                        convect.toy_convect_params(n=(8, 16)), convect.toy_convect_init)
    L = sim.layout
    assert np.abs(sim.interior().numpy()[L.UMX]).max() > 0.0
    run_port(sim, 2)


def test_test_convect_heating_layer():
    """Energy deposited against a control run without the source (the
    heating boosted so that two steps show it)."""
    jp = j_convect.test_convect_params(n=(8, 16), heating_peak=2.5e19)
    tp = convect.test_convect_params(n=(8, 16), heating_peak=2.5e19)
    js, sim = init_pair(jp, j_convect.test_convect_init, tp, convect.test_convect_init,
                        ext=convect.make_test_convect_source(tp),
                        jext=j_convect.make_test_convect_source(jp))
    ctl = Simulation(convect.test_convect_params(n=(8, 16)),
                     problem_init=convect.test_convect_init, device="cpu")
    ctl.init_data()
    L = sim.layout
    dt = float(sim._estdt_impl(sim.u)) * 0.4
    e1 = run_port(sim, 2, dt=dt)[L.UEINT].sum()
    ec = run_port(ctl, 2, dt=dt)[L.UEINT].sum()
    assert e1 > ec
    # the source itself against JAX's on the initial state
    ref = np.asarray(js.source_fns[-1](js, js.u, None, None, 0.0, dt))
    got = sim.source_fns[-1](sim, sim.u, None, None, 0.0, dt).numpy()
    same_state(got, ref, what="source")


def test_planet():
    js, sim = init_pair(j_se.planet_params(n=(8, 32)), j_se.planet_init,
                        se.planet_params(n=(8, 32)), se.planet_init)
    L = sim.layout
    u0 = sim.interior().numpy()
    vx = u0[L.UMX] / u0[L.URHO]
    assert vx.max() > 1e5 and vx.min() < -1e5
    run_port(sim, 3, frac=0.4)


def test_hse_general():
    js, sim = init_pair(j_gt.hse_general_params(n=32), j_gt.hse_general_init,
                        gt.hse_general_params(n=32), gt.hse_general_init)
    L = sim.layout
    ui = run_port(sim, 3)
    sel = ui[L.URHO] > 1e3
    assert np.abs(ui[L.UMX][sel] / ui[L.URHO][sel]).max() < 5e6


def test_acoustic_pulse_general():
    js, sim = init_pair(j_ap.general_params(n=12), j_ap.general_init,
                        ap.general_params(n=12), ap.general_init)
    L = sim.layout
    u0 = sim.interior().numpy()
    assert u0[L.UTEMP].max() > 1.2 * np.median(u0[L.UTEMP])
    run_port(sim, 3, frac=0.4)


def test_bwp_rad_raises_naming_item_9():
    """bwp-rad runs since radiation was ported (its 2D RZ setup against the
    JAX package in tests/test_torch_rad_setups_bwp.py); what of it still
    raises naming item 9 is its operator-split radiation in 3D, which would
    take the 3D CTU kernels on the radiation layout."""
    p = se.bwp_rad_params(n=(8, 16))
    assert p.radiation.hydro_coupling == 0
    p3 = p.with_ns("amr", n_cell=(8, 8, 8)).with_ns("geometry", coord_sys=0).with_ns(
        "castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), do_grav=0)
    with pytest.raises(NotImplementedError, match="item 9"):
        Simulation(p3, device="cpu")
