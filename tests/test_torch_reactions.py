"""The Strang-split reacting path of the PyTorch port against the JAX
package on the CPU: the stiff burner (powerlaw with the gamma law, iso7
with Helmholtz; aprox19 in test_torch_burn_aprox19.py), StrangReactor.react
with its gates, the burning timestep limiter, and the 1D detonation (10
steps at n = 64) against the JAX run and the JAX package's own golden
(tests/goldens/detonation.npz).

Tolerances, float64: one burn within 1e-8 of |jax| (mass fractions: 1e-8
absolute, they are O(1)); the burner's failure flags and its iteration
counts agree exactly (the count is read from JAX by capping its loop one
iteration below the port's count: exactly the zones that need that many
fail). The detonation's steps within 1e-8 |jax| + 1e-12 max|jax| per
component; against the golden, tests/test_regression.py's own bound,
1e-10 of each component's largest magnitude. The JAX side runs as the
JAX package's tests run it: its burner eagerly, its step jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.driver.timestep import estdt_burning as j_estdt_burning
from castro_tpu.eos.gamma_law import GammaLawEos as JGamma
from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.integrators.stiff import make_burner as j_make_burner
from castro_tpu.network.iso7 import Iso7Network as JIso7
from castro_tpu.network.powerlaw import PowerLawNetwork as JPowerLaw
from castro_tpu.problems import detonation as j_detonation
from castro_tpu.reactions.strang import StrangReactor as JStrang
from castro_tpu.state import StateLayout as JLayout
from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.driver.timestep import estdt_burning
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.integrators.stiff import make_burner
from castro_tpu_torch.network.iso7 import Iso7Network
from castro_tpu_torch.network.powerlaw import PowerLawNetwork
from castro_tpu_torch.problems import detonation
from castro_tpu_torch.reactions.strang import StrangReactor
from castro_tpu_torch.state import StateLayout

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)

TOL = dict(rtol=1e-8, atol=1e-8)
PL = dict(rtilde=10.0, nu=4.0, specific_q_burn=5.0)
# name: (jax network, port network, EOS pair, rho, T, dt); 6 zones each
CASES = {
    "powerlaw-gamma": (lambda: JPowerLaw(**PL), lambda: PowerLawNetwork(**PL),
                       (lambda n: JGamma(1.4, network=n), lambda n: GammaLawEos(1.4, network=n)),
                       1.0, 3.0, 4e-3),
    "iso7-helmholtz": (JIso7, Iso7Network, (JHelm, HelmholtzEos), 1e7, 1.5e9, 2e-8),
}


def _zones(jnet, jeos, rho0, T0, n=6, seed=0):
    rng = np.random.default_rng(seed)
    rho = rho0 * rng.uniform(0.5, 2.0, n)
    T = T0 * rng.uniform(0.8, 1.2, n)
    x = rng.uniform(0.0, 1.0, (jnet.nspec, n))
    x[1::3] = 0.0  # species at exactly zero: the tie of the clips
    x /= x.sum(0)
    e = np.asarray(jeos.rt(rho=jnp.asarray(rho), T=jnp.asarray(T), xn=jnp.asarray(x)).e)
    return rho, T, x, e


@pytest.fixture(scope="module", params=list(CASES))
def burn_case(request):
    jnet_f, tnet_f, (jeos_f, teos_f), rho0, T0, dt = CASES[request.param]
    jnet, tnet = jnet_f(), tnet_f()
    jeos, teos = jeos_f(jnet), teos_f(tnet)
    rho, T, x, e = _zones(jnet, jeos, rho0, T0)
    kw = dict(rtol=1e-6, atol_x=1e-8, atol_e=1e-6)
    tb = make_burner(tnet, teos, **kw)
    got = tb(*(torch.tensor(a) for a in (rho, T, x, e)), dt)
    steps = tb.stats.zone_steps.numpy()
    args = tuple(jnp.asarray(a) for a in (rho, T, x, e))
    ref = j_make_burner(jnet, jeos, **kw)(*args, dt)
    capped = j_make_burner(jnet, jeos, max_substeps=int(steps.max()) - 1, **kw)(*args, dt)
    return request.param, got, ref, steps, capped


def test_burner_matches_jax(burn_case):
    name, (xn, e, fail), (jxn, je, jfail), _, _ = burn_case
    np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=0, atol=TOL["atol"],
                               err_msg=name)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=TOL["rtol"], err_msg=name)
    assert fail.tolist() == np.asarray(jfail).tolist()
    assert abs(float(xn.sum(0).max()) - 1.0) < 1e-12


def test_burner_substeps_match_jax(burn_case):
    """The zones that need the port's largest iteration count are exactly
    those JAX fails when its loop stops one iteration short."""
    name, _, _, steps, (_, _, jfail_capped) = burn_case
    assert steps.max() > 2, name
    assert np.asarray(jfail_capped).tolist() == (steps == steps.max()).tolist(), \
        (name, steps.tolist())


def _layout_pair(nspec, shock):
    return (JLayout(dim=1, nspec=nspec, shock_var=shock),
            StateLayout(dim=1, nspec=nspec, shock_var=shock))


def _react_params(params_cls, **castro):
    p = params_cls()
    p = p.with_ns("castro", **castro)
    return p.with_ns("integrator", rtol_spec=1e-6, rtol_enuc=1e-6, atol_spec=1e-8,
                     atol_enuc=1e-6)


@pytest.mark.parametrize("gate", ["T-gate", "shock-off"])
def test_strang_react_matches_jax(gate):
    """react() on a 1D powerlaw state with the gamma law: the gated zones
    keep their state, the others burn; with disable_shock_burning the zones
    flagged in USHK do not burn."""
    jnet, tnet = JPowerLaw(**PL), PowerLawNetwork(**PL)
    jeos, teos = JGamma(1.4, network=jnet), GammaLawEos(1.4, network=tnet)
    rho, T, x, e = _zones(jnet, jeos, 1.0, 3.0, n=6, seed=3)
    shock = gate == "shock-off"
    jl, tl = _layout_pair(jnet.nspec, shock)
    u = np.zeros((tl.NVAR, 6))
    u[tl.URHO] = rho
    u[tl.UEINT] = rho * e
    u[tl.UEDEN] = rho * e
    u[tl.UTEMP] = T
    u[tl.UFS:tl.UFS + tl.nspec] = rho * x
    castro = dict(react_T_min=3.0) if gate == "T-gate" else dict(disable_shock_burning=1)
    shk = None
    if shock:
        u[tl.USHK] = [0.0, 1.0, 0.0, 1.0, 0.0, 0.0]
        shk = u[tl.USHK]
    dt = 2e-3
    jr = JStrang(_react_params(JParams, **castro).with_ns("network", **PL), jnet, jeos, jl)
    tr = StrangReactor(_react_params(Params, **castro).with_ns("network", **PL), tnet, teos, tl)
    jout = jr.react(jnp.asarray(u), dt, None if shk is None else jnp.asarray(shk))
    tout = tr.react(torch.tensor(u), dt, None if shk is None else torch.tensor(shk))
    for name, g, r in zip(("u", "omega_dot", "enuc"), tout[:3], jout[:3]):
        g, r = g.numpy(), np.asarray(r)
        # u: each component's own largest magnitude; the rates: all species
        # together (an inert species' rate is the normalization's rounding)
        scale = np.abs(r).max(axis=-1, keepdims=True) if name == "u" else np.abs(r).max()
        assert np.all(np.abs(g - r) <= TOL["rtol"] * np.abs(r) + 1e-12 * scale), name
    assert bool(tout[3]) == bool(jout[3])
    kept = (T < 3.0) if gate == "T-gate" else (u[tl.USHK] != 0.0)
    assert kept.any() and (~kept).any()
    np.testing.assert_array_equal(tout[0].numpy()[:, kept], u[:, kept])
    assert (np.abs(tout[2].numpy()[~kept]) > 0).all()


def test_strang_nse_builds_the_solver():
    """network.nse=1 (once a raise) gives the reactor its NSE solver; the
    bypass is held against the JAX package in tests/test_torch_nse.py."""
    p = Params().with_ns("network", nse=1)
    r = StrangReactor(p, Iso7Network(), GammaLawEos(network=Iso7Network()),
                      StateLayout(dim=1, nspec=7))
    assert r.nse is not None
    assert StrangReactor(Params(), Iso7Network(), GammaLawEos(network=Iso7Network()),
                         StateLayout(dim=1, nspec=7)).nse is None


def test_estdt_burning_matches_jax():
    """Both limiters (energy and mass fraction) on a 1D iso7 state with
    the gamma law, ghost zones included in the input, interior read."""
    jnet, tnet = JIso7(), Iso7Network()
    jeos = JGamma(network=jnet)
    rho, T, x, e = _zones(jnet, jeos, 1e7, 1.5e9, n=12, seed=5)
    jl, tl = _layout_pair(7, False)
    u = np.zeros((tl.NVAR, 12))
    u[tl.URHO], u[tl.UEINT], u[tl.UTEMP] = rho, rho * e, T
    u[tl.UFS:tl.UFS + 7] = rho * x
    args = (4, 0.2, 0.05, 1e-3)
    got = estdt_burning(torch.tensor(u), tl, GammaLawEos(network=tnet), tnet, *args)
    ref = j_estdt_burning(jnp.asarray(u), jl, jeos, jnet, *args)
    assert float(got) == pytest.approx(float(ref), rel=1e-10)
    off = estdt_burning(torch.tensor(u), tl, None, tnet, 4, 1e200, 1e200, 1e-3)
    assert off == float("inf")


@pytest.fixture(scope="module")
def detonation_runs():
    """10 steps of dt = 1e-6 at n = 64 (the golden's run) in both packages,
    from the JAX initial state."""
    jsim = JSimulation(j_detonation.make_params(n=64), problem_init=j_detonation.problem_init)
    jsim.init_data()
    sim = Simulation(detonation.make_params(n=64), problem_init=detonation.problem_init,
                     device="cpu")
    sim.init_data()
    u0 = np.asarray(jsim.u)
    ju, tu = jsim.u, torch.tensor(u0)
    t = 0.0
    for _ in range(10):
        ju, _, jbad = jsim._jit_step(ju, 1e-6, t)
        tu, _, bad = sim._step_impl(tu, 1e-6, t)
        assert not bool(jbad) and not bool(bad)
        t += 1e-6
    return sim, np.asarray(jsim.interior(ju)), sim.interior(tu).numpy(), sim.interior().numpy()


def test_detonation_matches_jax(detonation_runs):
    _, ref, got, _ = detonation_runs
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(got - ref) - (1e-8 * np.abs(ref) + 1e-12 * scale)
    assert err.max() <= 0.0, np.unravel_index(np.argmax(err), err.shape)
    # the burn moved the composition
    assert np.abs(ref[5] - got[5]).max() < 1e-6 * np.abs(ref[5]).max()


def test_detonation_matches_golden(detonation_runs):
    """The JAX package's golden (tests/test_regression.py), its bound."""
    _, _, got, _ = detonation_runs
    ref = np.load("tests/goldens/detonation.npz")["state"]
    assert got.shape == ref.shape
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert (np.abs(got - ref) / np.maximum(scale, 1e-300)).max() < 1e-10


def test_detonation_initial_state_matches_jax(detonation_runs):
    """The port's own initial state (problems/detonation.py) is the JAX one."""
    sim, _, _, own = detonation_runs
    jsim = JSimulation(j_detonation.make_params(n=64), problem_init=j_detonation.problem_init)
    jsim.init_data()
    ref = np.asarray(jsim.interior())
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(own - ref) <= 1e-12 * np.abs(ref) + 1e-14 * scale)
    assert sim.reactor is not None and sim.layout.nspec == 3
