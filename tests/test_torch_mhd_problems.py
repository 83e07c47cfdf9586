"""The MHD setups of the port (`problems/mhd_tests.py`, `orszag_tang.py`)
against the JAX package's: each setup's initial state and face fields
through both packages' MhdSimulation.init_data (the magnetic energy folded
into rho E, the MHD clean, the face fill), and the magnetized
Rayleigh-Taylor setup through `Simulation` with constant gravity (the old
source traced into the CTU-CT states and the time-centred corrector), two
steps. Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per state
component, the momenta and the face fields each sharing their vector's
largest magnitude; the JAX steps op by op."""

import importlib
import types

import numpy as np
import pytest
import torch

import jax

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import mhd_tests as jmt
from castro_tpu.problems import orszag_tang as jot

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import mhd_tests as tmt
from castro_tpu_torch.problems import orszag_tang as tot

from test_torch_radiation import _few_threads, close  # noqa: F401

jax.config.update("jax_enable_x64", True)
JMhd = importlib.import_module("castro_tpu.mhd").MhdSimulation
TMhd = importlib.import_module("castro_tpu_torch.mhd").MhdSimulation

SETUPS = {
    "brio_wu": (lambda m: m.brio_wu_params(n=64), lambda m: m.tube_init()),
    "dai_woodward": (lambda m: m.dai_woodward_params(n=64),
                     lambda m: m.tube_init(m.DAI_WOODWARD)),
    "fast_rarefaction": (lambda m: m.fast_rarefaction_params(n=64),
                         lambda m: m.tube_init(m.FAST_RAREFACTION)),
    "alfven": (lambda m: m.alfven_params(n=8), lambda m: m.alfven_init),
    "magnetosonic_fast": (lambda m: m.magnetosonic_params(n=16), lambda m: m.magnetosonic_init),
    "magnetosonic_slow": (lambda m: m.magnetosonic_params(n=16, type_wave=2),
                          lambda m: m.magnetosonic_init),
    "loop_advection": (lambda m: m.loop_advection_params(n=16), lambda m: m.loop_advection_init),
    "rt": (lambda m: m.rt_params(n=(8, 16), B_0=0.1), lambda m: m.rt_init),
    "species": (lambda m: m.species_params(n=32), lambda m: m.species_init),
}


def _check(ts_u, ts_b, js_u, js_b, L, ng, dim):
    isl = (slice(ng, -ng),) * dim
    close(ts_u[(slice(None),) + isl], np.asarray(js_u)[(slice(None),) + isl], what="u",
          vectors=[(L.UMX, L.UMY, L.UMZ)])
    close(torch.stack([bb[isl] for bb in ts_b]),
          np.stack([np.asarray(bb)[isl] for bb in js_b]), what="face B", vectors=[(0, 1, 2)])


@pytest.mark.parametrize("name", list(SETUPS) + ["orszag_tang"])
def test_initial_state(name):
    if name == "orszag_tang":
        pj, pt = jot.make_params(n=16), tot.make_params(n=16)
        ij, it = jot.problem_init, tot.problem_init
    else:
        mk_p, mk_i = SETUPS[name]
        pj, pt, ij, it = mk_p(jmt), mk_p(tmt), mk_i(jmt), mk_i(tmt)
    js = JMhd(pj, problem_init=ij)
    ts = TMhd(pt, problem_init=it, device="cpu")
    with jax.disable_jit():
        js.init_data()
    ts.init_data()
    L = ts.base.layout
    _check(ts.state.u, ts.state.b, js.state.u, js.state.b, L, ts.base.ng, L.dim)
    assert ts.div_b_max() < 1e-12
    if name == "species":
        assert L.nspec == 2


def test_rt_through_simulation_with_constant_gravity():
    """RT (B_0 = 0.1 along x) through Simulation: constant gravity's old
    source in the CTU-CT states, its corrector after; two steps at the JAX
    run's dt."""
    def jinit(sim, u, b):
        return jmt.rt_init(types.SimpleNamespace(base=sim), u, b)

    js = JSim(jmt.rt_params(n=(16, 32), B_0=0.1), problem_init=jinit)
    ts = Simulation(tmt.rt_params(n=(16, 32), B_0=0.1), problem_init=tmt.rt_init, device="cpu")
    with jax.disable_jit():
        js.init_data()
        ts.init_data()
        assert any(getattr(fn, "name", "") == "grav" for fn in ts.source_fns)
        for _ in range(2):
            dt = js.estimate_dt()
            assert abs(ts.estimate_dt() - dt) <= 1e-12 * dt
            js.advance(dt)
            ts.advance(dt)
            js.step_count += 1
            ts.step_count += 1
    L = ts.layout
    _check(ts.u, ts.u_b, js.u, js.u_b, L, ts.ng, L.dim)
    # div B over the interior less 4 cells (tests/test_mhd.py): at a wall
    # the face fill pins the hi wall face to 0 after the CT update has moved
    # it, in both packages, so the cells beside the y walls carry the
    # wall's By (1e-8 here)
    inner = (slice(ts.ng + 4, -ts.ng - 4),) * 2
    assert float(ts.mhd.div_b(ts.u_b)[inner].abs().max()) < 1e-11
