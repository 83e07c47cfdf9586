"""Reactions on an AMR hierarchy: the 1D detonation (powerlaw network,
Strang burns on every level's step) on two levels against the JAX
package's AmrSimulation, with a burn failure forced on the first burn,
which fails level 0's first step and takes the hierarchy's retry in both
packages alike. Float64, jit disabled on the JAX side (as
tests/test_torch_amr.py); each level within 1e-8 of |jax| plus 1e-8 of the
component's largest magnitude (the coupled-step budget of a stiff burn:
the burner agrees to 1e-8, tests/test_torch_reactions.py).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import detonation as jdetonation
from castro_tpu.reactions.strang import StrangReactor as JStrang
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.problems import detonation
from castro_tpu_torch.reactions.strang import StrangReactor

from test_torch_amr import assert_same_hierarchy, step_both

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(mod):
    p = mod.make_params(n=32)
    return p.with_ns("amr", max_level=1, regrid_int=0)


def _hot_box(x):
    return (x > 0.8) & (x < 1.6)  # the front, where the hot fuel meets the cold


def _fail_first_burn(monkeypatch, cls, calls):
    """Make the first react() of this package report a failed burn."""
    react = cls.react

    def failing(self, u, dt, shk=None):
        out = react(self, u, dt, shk)
        calls.append(len(calls))
        if len(calls) == 1:
            fail = jnp.asarray(True) if cls is JStrang else out[3] | True
            return out[:3] + (fail,)
        return out

    monkeypatch.setattr(cls, "react", failing)


def test_detonation_on_two_levels_with_a_burn_retry(monkeypatch):
    jcalls, calls = [], []
    _fail_first_burn(monkeypatch, JStrang, jcalls)
    _fail_first_burn(monkeypatch, StrangReactor, calls)

    def tag(sim, u_int, level):
        return _hot_box(sim.geom.cell_centers_1d(0, 0))

    def jtag(sim, u_int, level):
        return _hot_box(jnp.asarray(sim.geom.cell_centers_1d(0, 0)))

    port = AmrSimulation(_params(detonation), problem_init=detonation.problem_init,
                         problem_tagging=tag, device="cpu")
    port.init_data()
    with jax.disable_jit():
        jamr = JAmr(_params(jdetonation), problem_init=jdetonation.problem_init,
                    problem_tagging=jtag)
        jamr.init_data()
        assert int(port.masks[1].sum()) > 0
        assert_same_hierarchy(port, jamr, what="init")
        step_both(port, jamr, 2, dt=2e-6)
        assert_same_hierarchy(port, jamr, rtol=1e-8, what="after 2 steps")
    # the failed first step was retried: more burns than the 2 steps x (level
    # 0 + 2 fine substeps) x 2 halves of a run without failure
    assert len(calls) == len(jcalls) > 2 * 3 * 2
    assert port.num_zones_advanced == jamr.num_zones_advanced
    fuel = port.interior(0)[port.sim0.layout.UFS] / port.interior(0)[0]
    assert float(fuel.min()) < 1.0  # the hot fuel burned
    assert port.sim0.reactor is not None
