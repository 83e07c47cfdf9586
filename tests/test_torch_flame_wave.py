"""flame_wave, the slice's main path, in the port against the JAX package
on the CPU, float64, at 16 x 16: the JAX package's dt, and two steps of
everything a flame_wave step does but its Strang burns (conduction,
constant gravity with its corrector, the isothermal HSE fill of the lower
face after every fill, periodic x, the 2D CTU step with Helmholtz) from
the JAX initial state. The burns are off on both sides here: the JAX
package's aprox13 + Helmholtz burner compiles for some 40 s on a CPU,
so the burn of the same state is held on its own in
test_torch_flame_wave_burn.py, and the Strang coupling of a whole step
with conduction, gravity and rotation in test_torch_rotation.py
(convective_flame) and test_torch_diffusion.py (toy_flame). The JAX step
runs op by op with its EOS modes jitted (`jitted_eos`).

Tolerance: 1e-10 |jax| + 1e-12 max|jax| per component, interiors only.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.problems import flame_wave
from test_torch_hse_fills import jax_flame_wave, jitted_eos

jax.config.update("jax_enable_x64", True)

N = (16, 16)
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flame_wave_steps():
    js = jax_flame_wave(N)
    sim = flame_wave.build(n=N, device="cpu")
    sim.init_data()
    dt = float(js._jit_estdt(js.u))
    dts = (dt, float(sim._estdt_impl(sim.u)))
    js.reactor, sim.reactor = None, None
    ju = js.u
    tu = torch.tensor(np.asarray(ju))
    t = 0.0
    states = []
    # the wrappers the step calls, counted (on the CPU they run their
    # plain versions and count no launch)
    calls = {"cmpflx": 0, "trans_cmpflx": 0, "prim_aux": 0, "clean_fill": 0}
    wrappers = {name: getattr(K, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return wrappers[name](*a, **kw)
        return call

    for name in calls:
        setattr(K, name, counted(name))
    try:
        for _ in range(2):
            with jitted_eos(js.eos):
                ju, _, bad = js._step_impl(ju, dt, t)
            assert not bool(bad)
            tu, _, flag = sim._step_impl(tu, dt, t)
            assert not bool(flag)
            states.append((np.asarray(js.interior(ju)), sim.interior(tu).numpy()))
            t += dt
    finally:
        for name, f in wrappers.items():
            setattr(K, name, f)
    return sim, dts, states, calls


def test_flame_wave_dt_matches_jax(flame_wave_steps):
    """The step's dt: CFL, burning (dtnuc_e) and conduction limiters."""
    _, (jdt, tdt), _, _ = flame_wave_steps
    assert tdt == pytest.approx(jdt, rel=RTOL)


@pytest.mark.parametrize("step", [0, 1])
def test_flame_wave_steps_match_jax(flame_wave_steps, step):
    sim, _, states, _ = flame_wave_steps
    ref, got = states[step]
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1)[:, None, None]
    err = np.abs(got - ref) - (RTOL * np.abs(ref) + 1e-12 * scale)
    assert err.max() <= 0.0, np.unravel_index(np.argmax(err), err.shape)
    L = sim.layout
    assert np.abs(got[L.UMY]).max() > 0.0  # the gas moves


def test_flame_wave_step_structure(flame_wave_steps):
    """A 2D step with a fill hook: the cmpflx and trans_cmpflx wrappers
    twice each (their plain versions here), prim_aux and clean_fill in
    torch ops."""
    sim, _, _, calls = flame_wave_steps
    assert not sim._kernel_prim and not sim._kernel_clean_fill
    assert calls == {"cmpflx": 4, "trans_cmpflx": 4, "prim_aux": 0, "clean_fill": 0}
