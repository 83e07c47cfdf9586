"""The port's driver against the JAX package's, on the CPU: `advance`
with its retry after a failed step, and a restart from a JAX checkpoint,
on the 3D Sedov blast (n = 16, float64) with jit disabled on the JAX side.
Tolerance: rtol = 1e-10 with an absolute floor of 1e-10 times the
component's largest magnitude, as in tests/test_torch_sedov.py.
"""

import json

import numpy as np
import pytest
import torch

import jax

from castro_tpu.driver import io as jio
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import sedov as jsedov

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import sedov

N = 16


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(mod, bc):
    p = mod.make_params(n=N, dim=3, stop_time=0.1, r_init=0.2, dtype="float64")
    return p.with_ns("castro", lo_bc=(bc,) * 3, hi_bc=(bc,) * 3)


def _assert_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    atol = 1e-10 * np.abs(ref).reshape(ref.shape[0], -1).max(1)
    np.testing.assert_array_less(np.abs(got - ref),
                                 1e-10 * np.abs(ref) + atol[:, None, None, None] + 1e-300,
                                 err_msg=what)


def test_advance_retries_like_jax():
    """A dt 1.5 times the Courant limit fails the Courant check; advance
    then subcycles, in both packages the same way."""
    out = {}
    with jax.disable_jit():
        js = JSim(_params(jsedov, 2), problem_init=jsedov.problem_init)
        js.init_data()
        dt = 1.5 * float(js._estdt_impl(js.u)) / js.params.castro.cfl
        u0 = np.asarray(js.u)
        _, status = js.try_step(dt)
        assert not status.success
        js.advance(dt)
        out["jax"] = (np.asarray(js.interior()), js.t, js.num_zones_advanced)
    sim = Simulation(_params(sedov, 2), problem_init=sedov.problem_init,
                     device="cpu")
    sim.u = convert.state_from_numpy(u0, sim.layout, "cpu", sim.dtype)
    assert not sim.try_step(dt)[1].success
    assert sim.advance(dt) == dt
    assert sim.t == pytest.approx(out["jax"][1], rel=1e-15)
    assert sim.num_zones_advanced == out["jax"][2] > N ** 3  # it did subcycle
    _assert_close(sim.interior(), out["jax"][0], "after the retry")


def test_restart_from_jax_checkpoint(tmp_path):
    """Restart the port from a JAX checkpoint, then take k steps in each."""
    k = 2
    with jax.disable_jit():
        js = JSim(_params(jsedov, 3), problem_init=jsedov.problem_init)
        js.init_data()
        js.run(max_step=1, verbose=False)
        path = jio.write_checkpoint(js, str(tmp_path / "chk00001"))
        js.run(max_step=1 + k, verbose=False)
        ref = np.asarray(js.interior())
    with open(tmp_path / "chk00001" / "meta.json") as f:
        meta = json.load(f)
    sim = Simulation(_params(sedov, 3), problem_init=sedov.problem_init,
                     device="cpu")
    convert.restart_from_jax_checkpoint(sim, path)
    assert (sim.t, sim.step_count, sim.dt) == (meta["time"], meta["step"], meta["dt"])
    sim.run(max_step=1 + k, verbose=False)
    assert sim.step_count == 1 + k
    _assert_close(sim.interior(), ref, "after restart")
    bad = dict(meta, state_variables=meta["state_variables"][::-1])
    with open(tmp_path / "chk00001" / "meta.json", "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="state variables"):
        convert.restart_from_jax_checkpoint(sim, path)
