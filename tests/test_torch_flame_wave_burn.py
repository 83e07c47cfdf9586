"""flame_wave's Strang burn in the port against the JAX package on the CPU,
float64: `StrangReactor.react` (aprox13 with the Helmholtz EOS, the
reactor's integrator tolerances) for half of the first step's dt on the
hot ignition patch of flame_wave's initial state at 32 x 16, the burn
that a flame_wave step runs twice (test_torch_flame_wave.py holds the
rest of the step).

Tolerance: the state within 1e-8 |jax| + 1e-12 max|jax| per component,
equal failure flags (the burner's budget, tests/test_torch_reactions.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.problems import flame_wave as j_flame_wave
from castro_tpu_torch.problems import flame_wave

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_flame_wave_half_burn_matches_jax():
    """From the port's initial state (the JAX one within 1e-10,
    test_torch_hse_fills.py) and its dt (test_torch_flame_wave.py)."""
    js = j_flame_wave.build(n=(32, 16))
    sim = flame_wave.build(n=(32, 16), device="cpu")
    sim.init_data()
    dt = float(sim._estdt_impl(sim.u))
    # the patch: x within 300 cm of 500 cm, the four lowest rows
    ng = sim.ng
    u = sim.u.numpy()[:, ng + 4:ng + 12, ng:ng + 4]
    assert u[sim.layout.UTEMP].max() > 3.5e8
    # jitted whole: one program in place of the burner's loop bodies
    # compiled op by op (the same operations, a few seconds less to build)
    ref, _, _, jfail = jax.jit(js.reactor.react)(jnp.asarray(u), 0.5 * dt)
    got, _, _, fail = sim.reactor.react(torch.tensor(u), 0.5 * dt)
    ref, got = np.asarray(ref), got.numpy()
    assert bool(fail) == bool(jfail) is False
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1)[:, None, None]
    err = np.abs(got - ref) - (1e-8 * np.abs(ref) + 1e-12 * scale)
    assert err.max() <= 0.0, np.unravel_index(np.argmax(err), err.shape)
    L = sim.layout
    assert (got[L.UEINT] - u[L.UEINT]).max() > 0.0  # the hot zones released energy
    assert got[L.UFS + 1].max() > 0.0  # and made carbon
