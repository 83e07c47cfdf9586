"""Thermal diffusion in the port against the JAX package on the CPU, float64:
`DiffusionSource` (constant conductivity, the power law k0 T^nu, the
diffuse_cutoff_density mask) on a seeded 2D state, the conduction
timestep limiter `estdt_temp_diffusion` (gamma law and Helmholtz), the
limiter inside the step's dt, the conductivity read from inputs text, and
two steps of toy_flame (1D powerlaw flame with `diffuse_temp`).

Tolerances: the source and the limiter within 1e-10 relative, interiors
only (the stencil runs on the grown grid through `shifted`,
castro_tpu/ops/stencil.py:5-9); the toy_flame steps, which burn, within
1e-8 |jax| + 1e-12 max|jax| per component (tests/test_torch_reactions.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.driver.timestep import estdt_temp_diffusion as j_estdt_diff
from castro_tpu.eos.gamma_law import GammaLawEos as JGamma
from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.geometry import geometry_from_params as j_geometry
from castro_tpu.network.iso7 import Iso7Network as JIso7
from castro_tpu.problems import toy_flame as j_toy_flame
from castro_tpu.sources.diffusion_src import DiffusionSource as JDiffusion
from castro_tpu.state import StateLayout as JLayout
from castro_tpu_torch.config import Params, parse_inputs_text
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.driver.timestep import estdt_temp_diffusion
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.geometry import geometry_from_params
from castro_tpu_torch.network.iso7 import Iso7Network
from castro_tpu_torch.problems import toy_flame
from castro_tpu_torch.sources import build_sources
from castro_tpu_torch.sources.diffusion_src import DiffusionSource
from castro_tpu_torch.state import StateLayout

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
NG = 4
N = (12, 10)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(cls, **castro):
    p = cls().with_ns("amr", n_cell=N)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(1.2, 2.0, 1.0))
    return p.with_ns("castro", **castro).with_ns("tpu", dtype="float64")


def _state(nspec, rho_scale=1.0, T_scale=1.0, seed=0):
    """A seeded iso7-layout 2D state on the grown grid (rho, T, e; the
    composition sums to one)."""
    L = StateLayout(dim=2, nspec=nspec)
    shape = tuple(n + 2 * NG for n in N)
    rng = np.random.default_rng(seed)
    rho = rho_scale * rng.uniform(0.2, 2.0, shape)
    T = T_scale * rng.uniform(0.5, 2.0, shape)
    x = rng.uniform(0.0, 1.0, (nspec,) + shape)
    x /= x.sum(0)
    u = np.zeros((L.NVAR,) + shape)
    u[L.URHO], u[L.UTEMP] = rho, T
    u[L.UFS:L.UFS + nspec] = rho * x
    return L, u


def _interior(a):
    return np.asarray(a)[(slice(None),) + (slice(NG, -NG),) * 2]


@pytest.mark.parametrize("case", ["constant", "power-law", "cutoff"])
def test_diffusion_source_matches_jax(case):
    extra = {"conductivity.const_conductivity": 3.0e2}
    castro = {}
    if case != "constant":
        extra["conductivity.cond_exponent"] = 2.5
    if case == "cutoff":
        castro["diffuse_cutoff_density"] = 1.0
    L, u = _state(7, seed=1)
    jp = _params(JParams, **castro).replace(extra=extra)
    tp = _params(Params, **castro).replace(extra=extra)
    jsrc = JDiffusion(jp, j_geometry(jp, jnp.float64), JLayout(dim=2, nspec=7), NG)
    tsrc = DiffusionSource(tp, geometry_from_params(tp, torch.float64, "cpu"), L, NG)
    ref = _interior(jsrc(None, jnp.asarray(u), None, None, 0.0, 1e-3))
    got = _interior(tsrc(None, torch.tensor(u), None, None, 0.0, 1e-3))
    assert np.abs(ref[L.UEINT]).max() > 0.0
    np.testing.assert_array_equal(got[L.UEINT], got[L.UEDEN])
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)
    others = [c for c in range(L.NVAR) if c not in (L.UEINT, L.UEDEN)]
    assert not got[others].any()
    if case == "cutoff":  # no flux through a face of a zone below the cutoff
        rho = _interior(u)[L.URHO]
        assert (rho < 1.0).any() and (rho >= 1.0).any()


@pytest.mark.parametrize("eos", ["gamma_law", "helmholtz"])
def test_estdt_temp_diffusion_matches_jax(eos):
    extra = {"conductivity.const_conductivity": 1.0e18, "conductivity.cond_exponent": 1.5}
    if eos == "gamma_law":
        jeos, teos = JGamma(1.4, network=JIso7()), GammaLawEos(1.4, network=Iso7Network())
        L, u = _state(7, seed=2)
    else:
        jeos, teos = JHelm(network=JIso7()), HelmholtzEos(network=Iso7Network())
        L, u = _state(7, rho_scale=1e6, T_scale=3e8, seed=2)
    # e from (rho, T) through the EOS, so that re() inverts a real state
    rho = u[L.URHO]
    x = u[L.UFS:L.UFS + 7] / rho
    u[L.UEINT] = rho * np.asarray(jeos.rt(rho=jnp.asarray(rho), T=jnp.asarray(u[L.UTEMP]),
                                          xn=jnp.asarray(x)).e)
    jp = _params(JParams, do_thermal_diffusion=1).replace(extra=extra)
    tp = _params(Params, do_thermal_diffusion=1).replace(extra=extra)
    jg, tg = j_geometry(jp, jnp.float64), geometry_from_params(tp, torch.float64, "cpu")
    jsrc = JDiffusion(jp, jg, JLayout(dim=2, nspec=7), NG)
    tsrc = DiffusionSource(tp, tg, L, NG)
    ref = j_estdt_diff(jnp.asarray(u), JLayout(dim=2, nspec=7), jeos, jg, NG, jsrc)
    got = estdt_temp_diffusion(torch.tensor(u), L, teos, tg, NG, tsrc)
    assert float(got) == pytest.approx(float(ref), rel=RTOL)
    assert estdt_temp_diffusion(torch.tensor(u), L, teos, tg, NG, None) == float("inf")


def test_conductivity_from_inputs_text_and_source_order():
    """`conductivity.*` keys parse to numbers the source reads; the sources
    come in the reference's order (diff, grav, rot, sponge)."""
    text = "\n".join(["castro.do_thermal_diffusion = 1", "castro.do_grav = 1",
                      "castro.do_rotation = 1", "castro.rotational_period = 2.0",
                      "castro.do_sponge = 1", "gravity.gravity_type = ConstantGrav",
                      "conductivity.const_conductivity = 1e18",
                      "conductivity.cond_exponent = 2"])
    p = parse_inputs_text(text, base=_params(Params))
    L = StateLayout(dim=2, nspec=1)
    srcs = build_sources(p, geometry_from_params(p, torch.float64, "cpu"), L, NG)
    assert [s.name for s in srcs] == ["diff", "grav", "rot", "sponge"]
    assert isinstance(srcs[0].k0, float) and srcs[0].k0 == 1e18
    assert srcs[0].nu == 2.0
    assert build_sources(p.with_ns("castro", do_thermal_diffusion=0, diffuse_temp=1),
                         geometry_from_params(p, torch.float64, "cpu"), L, NG)[0].name == "diff"


@pytest.fixture(scope="module")
def toy_flame_runs():
    """Two steps of toy_flame at n = 64 in both packages from the JAX
    initial state, with the JAX package's dt (its burn phase jitted, the
    rest op by op)."""
    js = JSimulation(j_toy_flame.make_params(n=64), problem_init=j_toy_flame.problem_init)
    js.init_data()
    sim = Simulation(toy_flame.make_params(n=64), problem_init=toy_flame.problem_init,
                     device="cpu")
    sim.init_data()
    own0 = sim.interior().numpy()
    dts = (float(js._jit_estdt(js.u)), float(sim._estdt_impl(sim.u)))
    burn = jax.jit(lambda u, dt, t: js._step_impl(u, dt, t, phase="burn"))
    ju = js.u
    tu = torch.tensor(np.asarray(ju))
    t, dt = 0.0, dts[0]
    states = []
    for _ in range(2):
        ju, bf1 = burn(ju, dt, t)
        with jax.disable_jit():
            ju, _, bad = js._step_impl(ju, dt, t, phase="mid")
        ju, bf2 = burn(ju, dt, t + dt)
        assert not (bool(bf1) or bool(bf2) or bool(bad))
        tu, _, flag = sim._step_impl(tu, dt, t)
        assert not bool(flag)
        states.append((np.asarray(js.interior(ju)), sim.interior(tu).numpy()))
        t += dt
    return js, sim, own0, dts, states


def test_toy_flame_initial_state_and_dt_match_jax(toy_flame_runs):
    js, sim, own0, (jdt, tdt), _ = toy_flame_runs
    ref = np.asarray(js.interior())
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(own0 - ref) <= 1e-12 * np.abs(ref) + 1e-14 * scale)
    assert tdt == pytest.approx(jdt, rel=RTOL)
    # the conduction limit of this state, which enters the step's dt
    jdiff = j_estdt_diff(js.u, js.layout, js.eos, js.geom, js.ng, js.source_fns[0])
    tdiff = estdt_temp_diffusion(sim.u, sim.layout, sim.eos, sim.geom, sim.ng,
                                 sim.source_fns[0])
    assert float(tdiff) == pytest.approx(float(jdiff), rel=RTOL)
    assert tdt <= float(tdiff)
    assert [s.name for s in sim.source_fns] == ["diff"]


@pytest.mark.parametrize("step", [0, 1])
def test_toy_flame_steps_match_jax(toy_flame_runs, step):
    ref, got = toy_flame_runs[4][step]
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(got - ref) - (1e-8 * np.abs(ref) + 1e-12 * scale)
    assert err.max() <= 0.0, np.unravel_index(np.argmax(err), err.shape)
    # conduction and the burn moved the energy
    assert np.abs(got[4] - toy_flame_runs[2][4]).max() > 0.0
