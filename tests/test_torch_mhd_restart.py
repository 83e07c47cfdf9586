"""Restart the port from the JAX package's checkpoint of an MHD run
(`castro_tpu/driver/io.py:write_checkpoint`, whose state.npz carries the
face fields `u_b0` .. `u_b2`) and take the next step in both: Orszag-Tang
16^2 through `Simulation`. A checkpoint and a simulation that differ in
castro.do_mhd raise, either way round. Tolerance: float64 1e-10 |jax| +
1e-10 max|jax| per state component, the momenta and the face fields each
sharing their vector's largest magnitude; the JAX steps op by op."""

import types

import numpy as np
import pytest
import torch

import jax

from castro_tpu.driver import io as jio
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import orszag_tang as jot

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import orszag_tang as tot

from test_torch_radiation import _few_threads, close  # noqa: F401

jax.config.update("jax_enable_x64", True)


def _jinit(sim, u, b):
    return jot.problem_init(types.SimpleNamespace(base=sim), u, b)


def test_restart_mhd_from_jax_checkpoint(tmp_path):
    js = JSim(jot.make_params(n=16), problem_init=_jinit)
    with jax.disable_jit():
        js.init_data()
        js.run(max_step=1, verbose=False)
        path = jio.write_checkpoint(js, str(tmp_path / "chk00001"))
        js.run(max_step=2, verbose=False)
    sim = Simulation(tot.make_params(n=16), device="cpu")
    convert.restart_from_jax_checkpoint(sim, path)
    assert sim.u_b is not None and sim.step_count == 1
    sim.run(max_step=2, verbose=False)
    L = sim.layout
    close(sim.interior(), np.asarray(js.interior()), what="u", vectors=[(L.UMX, L.UMY, L.UMZ)])
    isl = (slice(sim.ng, -sim.ng),) * 2
    close(torch.stack([bb[isl] for bb in sim.u_b]),
          np.stack([np.asarray(bb)[isl] for bb in js.u_b]), what="face B", vectors=[(0, 1, 2)])
    # do_mhd must agree, either way round
    hydro = Simulation(tot.make_params(n=16).with_ns("castro", do_mhd=0), device="cpu")
    with pytest.raises(ValueError, match="do_mhd"):
        convert.restart_from_jax_checkpoint(hydro, path)
    jh = JSim(jot.make_params(n=16).with_ns("castro", do_mhd=0))
    jh.init_data()
    hpath = jio.write_checkpoint(jh, str(tmp_path / "chk_hydro"))
    with pytest.raises(ValueError, match="do_mhd"):
        convert.restart_from_jax_checkpoint(Simulation(tot.make_params(n=16), device="cpu"),
                                            hpath)
