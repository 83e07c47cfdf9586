"""Rotation and external sources in the port against the JAX package on the
CPU, float64: `RotationSource` in the rotating frame (Coriolis and
centrifugal) and in the inertial frame, in 2D and 3D; its corrector with
rot_source_type 1-4, explicit and with the implicit dt-omega update at
Omega dt = 3; an external source through `Simulation(ext_src=...)`; and
one step of convective_flame (powerlaw burning, conduction, constant
gravity and rotation: two correctors in one step, their old-time terms
taken out of the generic pair).

Tolerances: the sources within 1e-10 of each component's largest
magnitude, interiors only; the steps within 1e-8 |jax| + 1e-12 max|jax|
per component (a burn's budget, tests/test_torch_reactions.py; 1e-10 for
the step without a burn).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.geometry import geometry_from_params as j_geometry
from castro_tpu.problems import convective_flame as j_convective_flame
from castro_tpu.problems import sod as j_sod
from castro_tpu.sources.rotation_src import RotationSource as JRotation
from castro_tpu.state import StateLayout as JLayout
from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.geometry import geometry_from_params
from castro_tpu_torch.problems import convective_flame, sod
from castro_tpu_torch.sources import build_sources
from castro_tpu_torch.sources.rotation_src import RotationSource
from castro_tpu_torch.state import StateLayout

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
NG = 4


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(cls, dim, **castro):
    n = (10, 8, 6)[:dim]
    p = cls().with_ns("amr", n_cell=n)
    p = p.with_ns("geometry", prob_lo=(-1.0, -0.5, 0.0), prob_hi=(1.0, 1.5, 1.2))
    kw = dict(do_rotation=1, rotational_period=2.0)
    kw.update(castro)
    return p.with_ns("castro", **kw).with_ns("tpu", dtype="float64")


def _states(dim, seed):
    """(u_old, u_new): seeded states on the grown grid, rho > 0 and moving."""
    L = StateLayout(dim=dim, nspec=1)
    shape = tuple(n + 2 * NG for n in (10, 8, 6)[:dim])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        u = np.zeros((L.NVAR,) + shape)
        rho = rng.uniform(0.5, 2.0, shape)
        u[L.URHO] = rho
        u[L.UMX:L.UMZ + 1] = rho * rng.uniform(-1.0, 1.0, (3,) + shape)
        u[L.UEINT] = rng.uniform(1.0, 2.0, shape)
        u[L.UEDEN] = u[L.UEINT] + 0.5 * (u[L.UMX:L.UMZ + 1] ** 2).sum(0) / rho
        u[L.UFS] = rho
        out.append(u)
    return L, out


def _pair(dim, **castro):
    jp, tp = _params(JParams, dim, **castro), _params(Params, dim, **castro)
    L = StateLayout(dim=dim, nspec=1)
    jsrc = JRotation(jp, j_geometry(jp, jnp.float64), JLayout(dim=dim, nspec=1), NG)
    tsrc = RotationSource(tp, geometry_from_params(tp, torch.float64, "cpu"), L, NG)
    return jsrc, tsrc


def _close(got, ref, what):
    inner = (slice(None),) + (slice(NG, -NG),) * (got.ndim - 1)
    got, ref = np.asarray(got)[inner], np.asarray(ref)[inner]
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1).reshape((-1,) + (1,) * (ref.ndim - 1))
    assert np.all(np.abs(got - ref) <= RTOL * scale), what


FRAMES = {"rotating": {}, "inertial": dict(state_in_rotating_frame=0),
          "centrifugal only": dict(rotation_include_coriolis=0)}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_rotation_source_matches_jax(frame, dim):
    jsrc, tsrc = _pair(dim, rot_axis=3 if dim == 2 else 2, **FRAMES[frame])
    L, (u, _) = _states(dim, seed=dim)
    ref = jsrc(None, jnp.asarray(u), None, None, 0.0, 1e-2)
    got = tsrc(None, torch.tensor(u), None, None, 0.0, 1e-2).numpy()
    assert np.abs(got[L.UMX]).max() > 0.0 and np.abs(got[L.UEDEN]).max() > 0.0
    _close(got, ref, frame)


@pytest.mark.parametrize("implicit", [1, 0], ids=["implicit", "explicit"])
@pytest.mark.parametrize("rst", [1, 2, 3, 4])
def test_rotation_corrector_matches_jax(rst, implicit):
    """The corrector at Omega dt = 3 (period 2, dt 0.955): the implicit
    update stays bounded where the explicit one would not."""
    dt = 3.0 / np.pi
    jsrc, tsrc = _pair(3, rot_source_type=rst, implicit_rotation_update=implicit)
    L, (uo, un) = _states(3, seed=10 + rst)
    ref = jsrc.corrector(None, jnp.asarray(uo), jnp.asarray(un), 0.0, dt)
    got = tsrc.corrector(None, torch.tensor(uo), torch.tensor(un), 0.0, dt).numpy()
    assert np.all(np.isfinite(got)) and np.abs(got[L.UEDEN]).max() > 0.0
    _close(got, ref, f"rot_source_type={rst}")


def _heat(xp, rate):
    """An external source: uniform heating of `rate` erg/cm^3/s."""
    if xp is jnp:
        def ext_src(sim, u, q, qaux, t, dt, ctx=None):
            L = sim.layout
            return jnp.zeros_like(u).at[L.UEINT].set(rate).at[L.UEDEN].set(rate)
    else:
        def ext_src(sim, u, q, qaux, t, dt, ctx=None):
            L = sim.layout
            src = torch.zeros_like(u)
            src[L.UEINT] = rate
            src[L.UEDEN] = rate
            return src

    ext_src.name = "ext"
    return ext_src


def test_external_source_matches_jax():
    """1D Sod with castro.add_ext_src=1 and a heating hook, two steps; the
    hook is ignored without add_ext_src, and add_ext_src adds nothing
    without a hook (as in the JAX package)."""
    jp = j_sod.make_params(n=32, dim=1, dtype="float64").with_ns("castro", add_ext_src=1)
    tp = sod.make_params(n=32, dim=1, dtype="float64").with_ns("castro", add_ext_src=1)
    js = JSimulation(jp, problem_init=j_sod.problem_init, ext_src=_heat(jnp, 5.0))
    sim = Simulation(tp, problem_init=sod.problem_init, device="cpu", ext_src=_heat(torch, 5.0))
    assert [s.name for s in sim.source_fns] == ["ext"]
    js.init_data()
    sim.init_data()
    e0 = sim.interior()[sim.layout.UEINT].sum()
    for _ in range(2):
        js.advance(2e-3)
        sim.advance(2e-3)
    ref, got = np.asarray(js.interior()), sim.interior().numpy()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - ref) <= RTOL * np.abs(ref) + 1e-12 * scale)
    assert float(sim.interior()[sim.layout.UEINT].sum()) > float(e0)
    L = StateLayout(dim=1, nspec=1)
    g = geometry_from_params(tp, torch.float64, "cpu")
    assert build_sources(tp, g, L, NG) == []
    assert build_sources(tp.with_ns("castro", add_ext_src=0), g, L, NG,
                         ext_src=_heat(torch, 1.0)) == []


@pytest.fixture(scope="module")
def convective_flame_step():
    """One step of convective_flame at 16 x 12 in both packages from the
    JAX initial state, with the JAX package's dt (its burn phase jitted,
    the rest op by op)."""
    js = JSimulation(j_convective_flame.make_params(n=(16, 12)),
                     problem_init=j_convective_flame.problem_init)
    js.init_data()
    sim = Simulation(convective_flame.make_params(n=(16, 12)),
                     problem_init=convective_flame.problem_init, device="cpu")
    sim.init_data()
    own0 = sim.interior().numpy()
    dt = float(js._jit_estdt(js.u))
    tdt = float(sim._estdt_impl(sim.u))
    burn = jax.jit(lambda u, dt_, t: js._step_impl(u, dt_, t, phase="burn"))
    ju, bf1 = burn(js.u, dt, 0.0)
    with jax.disable_jit():
        ju, _, bad = js._step_impl(ju, dt, 0.0, phase="mid")
    ju, bf2 = burn(ju, dt, dt)
    assert not (bool(bf1) or bool(bf2) or bool(bad))
    tu, _, flag = sim._step_impl(torch.tensor(np.asarray(js.u)), dt, 0.0)
    assert not bool(flag)
    return js, sim, own0, (dt, tdt), np.asarray(js.interior(ju)), sim.interior(tu).numpy()


def test_convective_flame_init_matches_jax(convective_flame_step):
    js, sim, own0, (dt, tdt), _, _ = convective_flame_step
    ref = np.asarray(js.interior())
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(own0 - ref) <= RTOL * np.abs(ref) + 1e-14 * scale)
    assert tdt == pytest.approx(dt, rel=RTOL)
    assert [s.name for s in sim.source_fns] == ["diff", "grav", "rot"]
    assert sum(hasattr(s, "corrector") for s in sim.source_fns) == 2


def test_convective_flame_step_matches_jax(convective_flame_step):
    _, sim, own0, _, ref, got = convective_flame_step
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(got - ref) - (1e-8 * np.abs(ref) + 1e-12 * scale)
    assert err.max() <= 0.0, np.unravel_index(np.argmax(err), err.shape)
    L = sim.layout
    assert np.abs(got[L.UMX]).max() > 0.0  # rotation and gravity moved the gas
