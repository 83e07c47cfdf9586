"""The hydrostatic and ambient ghost fills, the gamma law's tp/ph modes,
hse_convergence and flame_wave's initial state in the port against the
JAX package on the CPU, float64. `make_hse_fill` on flame_wave's state
with Helmholtz (isothermal) and on hse_convergence's with the gamma law
(isothermal and through rp); `make_ambient_fill`; `GammaLawEos.tp` and
`.ph`; hse_convergence's steps and its convergence with resolution
(tests/test_hse_convergence.py); flame_wave's `_hse_column` and
`init_data` at 32 x 16 (its two steps are in test_torch_flame_wave.py;
the JAX initialization runs its EOS jitted, `jax_flame_wave`).

Tolerances: fills, EOS modes, the column and the initial state within
1e-10 relative (each component's largest magnitude for the state); the
hse_convergence steps within 1e-10 |jax| + 1e-12 max|jax| per component.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.gamma_law import GammaLawEos as JGamma
from castro_tpu.network.iso7 import Iso7Network as JIso7
from castro_tpu.problems import flame_wave as j_flame_wave
from castro_tpu.problems import hse_convergence as j_hse
from castro_tpu.problems.fills import make_ambient_fill as j_ambient
from castro_tpu.problems.fills import make_hse_fill as j_hse_fill
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.network.iso7 import Iso7Network
from castro_tpu_torch.problems import flame_wave, hse_convergence
from castro_tpu_torch.problems.fills import make_ambient_fill, make_hse_fill

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


def _same_state(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1).reshape((-1,) + (1,) * (ref.ndim - 1))
    err = np.abs(got - ref) - (rtol * np.abs(ref) + 1e-14 * scale)
    assert err.max() <= 0.0, np.unravel_index(np.argmax(err), err.shape)


@contextlib.contextmanager
def jitted_eos(eos):
    """The JAX EOS with its modes jitted while the block runs (one program
    a mode and shape): the marches and the steps run op by op call them
    some thousand times, each a few hundred operations eagerly (minutes a
    step for Helmholtz)."""
    cls = type(eos)
    modes = {}
    for mode, names in (("rt", ("rho", "T")), ("re", ("rho", "e")), ("rp", ("rho", "p")),
                        ("tp", ("T", "p"))):
        f = jax.jit(lambda a, b, xn, m=mode, k=names: getattr(cls, m)(
            eos, **{k[0]: a, k[1]: b}, xn=xn))
        modes[mode] = (f, names)
    for mode, (f, (n1, n2)) in modes.items():
        setattr(eos, mode, lambda f=f, n1=n1, n2=n2, **kw: f(kw[n1], kw[n2], kw.get("xn")))
    try:
        yield eos
    finally:
        for mode in modes:
            delattr(eos, mode)


def jax_flame_wave(n):
    """The JAX package's flame_wave, initialized with its EOS jitted."""
    js = j_flame_wave.build(n=n)
    with jitted_eos(js.eos):
        js.init_data()
    return js


@pytest.fixture(scope="module")
def flame_wave_pair():
    """flame_wave at 32 x 16 in both packages, initialized."""
    sim = flame_wave.build(n=(32, 16), device="cpu")
    sim.init_data()
    return jax_flame_wave((32, 16)), sim


def test_flame_wave_column_matches_jax(flame_wave_pair):
    """The port's column is the JAX initial state's density column (in the
    interior: the fills set the ghosts), and its pressure the JAX EOS's at
    that density and T_BASE."""
    js, sim = flame_wave_pair
    ng = sim.ng
    z = sim.geom.cell_centers_1d(1, ng).numpy()
    xn = np.zeros(13)
    xn[0] = 1.0
    rho, p = flame_wave._hse_column(sim.eos, xn, z - z[0], flame_wave.DENS_BASE,
                                    flame_wave.T_BASE)
    rho, p = rho[ng:-ng], p[ng:-ng]
    ref_rho = np.asarray(js.u)[js.layout.URHO, 0, ng:-ng]
    np.testing.assert_allclose(rho, ref_rho, rtol=RTOL, atol=0)
    ref_p = js.eos.rt(rho=jnp.asarray(ref_rho), T=jnp.full(rho.shape, j_flame_wave.T_BASE),
                      xn=jnp.asarray(np.repeat(xn[:, None], rho.size, 1))).p
    np.testing.assert_allclose(p, np.asarray(ref_p), rtol=RTOL, atol=0)
    assert np.all(np.diff(p) < 0.0)  # the pressure falls with height


def test_flame_wave_init_matches_jax(flame_wave_pair):
    js, sim = flame_wave_pair
    _same_state(sim.u.numpy(), js.u)
    L = sim.layout
    assert float(sim.interior()[L.UTEMP].max()) > 3.5e8  # the hot patch
    assert [s.name for s in sim.source_fns] == ["diff", "grav"]
    assert sim.reactor is not None and L.nspec == 13 and sim.problem_fill is not None


def test_flame_wave_hse_fill_matches_jax(flame_wave_pair):
    """The isothermal HSE fill of flame_wave's lower face (Helmholtz tp) on
    a perturbed copy of its state."""
    js, sim = flame_wave_pair
    u = np.asarray(js.u).copy()
    L, ng = sim.layout, sim.ng
    rng = np.random.default_rng(3)
    u[L.UEINT, :, ng] *= rng.uniform(0.9, 1.1, u.shape[1])
    jf = j_hse_fill(js, [(1, "lo")], j_flame_wave.G_CONST)
    tf = make_hse_fill(sim, [(1, "lo")], flame_wave.G_CONST)
    ref, got = np.asarray(jf(jnp.asarray(u))), tf(torch.tensor(u)).numpy()
    _same_state(got, ref)
    np.testing.assert_array_equal(got[:, :, ng:], u[:, :, ng:])  # the interior is kept
    assert np.all(got[L.URHO, :, :ng] > got[L.URHO, :, ng:ng + 1])  # denser below


@pytest.mark.parametrize("isothermal", [True, False], ids=["tp", "rp"])
def test_gamma_law_hse_fill_matches_jax(isothermal):
    """hse_convergence's two faces with the gamma law, isothermal (tp) or
    through rp."""
    js, sim = j_hse.build(n=32), hse_convergence.build(n=32, device="cpu")
    js.init_data()
    u = np.asarray(js.u)
    faces = [(0, "lo"), (0, "hi")]
    jf = j_hse_fill(js, faces, j_hse.G_CONST, isothermal=isothermal)
    tf = make_hse_fill(sim, faces, hse_convergence.G_CONST, isothermal=isothermal)
    ref, got = np.asarray(jf(jnp.asarray(u))), tf(torch.tensor(u)).numpy()
    _same_state(got, ref)


def test_ambient_fill_matches_jax():
    js, sim = j_hse.build(n=16), hse_convergence.build(n=16, device="cpu")
    js.init_data()
    u = np.asarray(js.u)
    amb = np.arange(1.0, sim.layout.NVAR + 1.0)
    ref = np.asarray(j_ambient(js, amb, [(0, "hi")])(jnp.asarray(u)))
    got = make_ambient_fill(sim, amb, [(0, "hi")])(torch.tensor(u)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, -sim.ng:], np.repeat(amb[:, None], sim.ng, 1))


@pytest.mark.parametrize("mode", ["tp", "ph"])
def test_gamma_law_tp_ph_match_jax(mode):
    jeos, teos = JGamma(5.0 / 3.0, network=JIso7()), GammaLawEos(5.0 / 3.0, network=Iso7Network())
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 1.0, (7, 9))
    x /= x.sum(0)
    a = rng.uniform(1e7, 1e9, 9)
    b = rng.uniform(1e20, 1e22, 9) if mode == "tp" else rng.uniform(1e15, 1e17, 9)
    if mode == "tp":
        ref = jeos.tp(T=jnp.asarray(a), p=jnp.asarray(b), xn=jnp.asarray(x))
        got = teos.tp(T=torch.tensor(a), p=torch.tensor(b), xn=torch.tensor(x))
        np.testing.assert_allclose(got.p.numpy(), b, rtol=1e-14)
    else:
        ref = jeos.ph(p=jnp.asarray(a * 1e13), h=jnp.asarray(b), xn=jnp.asarray(x))
        got = teos.ph(p=torch.tensor(a * 1e13), h=torch.tensor(b), xn=torch.tensor(x))
        np.testing.assert_allclose(got.h.numpy(), b, rtol=1e-14)
    for k in ("rho", "T", "p", "e", "h", "cs"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=RTOL, atol=0, err_msg=k)


def test_hse_convergence_steps_match_jax():
    """Five steps at n = 64 with the JAX package's dt, from its initial
    state; the JAX step jitted, as tests/test_hse_convergence.py runs it."""
    js, sim = j_hse.build(n=64), hse_convergence.build(n=64, device="cpu")
    js.init_data()
    sim.init_data()
    _same_state(sim.u.numpy(), js.u)
    dt = 0.5 * float(js._jit_estdt(js.u))
    assert 0.5 * float(sim._estdt_impl(sim.u)) == pytest.approx(dt, rel=RTOL)
    ju, tu = js.u, torch.tensor(np.asarray(js.u))
    for _ in range(5):
        ju, _, jbad = js._jit_step(ju, dt, 0.0)
        tu, _, bad = sim._step_impl(tu, dt, 0.0)
        assert not bool(jbad) and not bool(bad)
    ref, got = np.asarray(js.interior(ju)), sim.interior(tu).numpy()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - ref) <= RTOL * np.abs(ref) + 1e-12 * scale)


def _max_vel(n, nsteps=20):
    sim = hse_convergence.build(n=n, device="cpu")
    sim.init_data()
    dt = 0.5 * float(sim._estdt_impl(sim.u))
    u = sim.u
    for _ in range(nsteps):
        u, _, bad = sim._step_impl(u, dt, 0.0)
        assert not bool(bad)
    ui = sim.interior(u)
    L = sim.layout
    return float((ui[L.UMX] / ui[L.URHO]).abs().max())


def test_hse_balance_converges():
    """tests/test_hse_convergence.py's bounds on the port: the residual
    velocity is small and falls at least 3x from n = 64 to 128."""
    v64, v128 = _max_vel(64), _max_vel(128)
    assert v64 < 5e-4, v64
    assert v128 < v64 / 3.0, (v64, v128)
