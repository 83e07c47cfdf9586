"""The MHD steps of the port (`castro_tpu_torch/mhd/`, `MhdSimulation`)
against the JAX package's on the same initial data in 1D and 2D: the
CTU-CT step (castro.mhd_ctu=1; PPM, and PLM with characteristic or
primitive limiting) and the RK2 flux-CT step, on the Brio-Wu tube (n = 64)
and Orszag-Tang (32^2), each holding the state and the face fields after
a few steps at the JAX run's CFL dt. div B stays below 1e-11 (the
interior's max |div B|). Orszag-Tang's PPM CTU-CT step, in float64 and
float32, is in tests/test_torch_mhd_steps_2d.py, the 3D steps in
tests/test_torch_mhd_steps_3d.py.

The JAX side runs op by op (`jax.disable_jit()`): its step compiles for
8-40 s jitted. Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per state
component, the momenta and the three face fields each sharing their
vector's largest magnitude (`tests/test_torch_radiation.py:close`);
float32 rtol = atol = 2e-5. Interiors only.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from castro_tpu.problems import mhd_tests as jmt
from castro_tpu.problems import orszag_tang as jot

from castro_tpu_torch.problems import mhd_tests as tmt
from castro_tpu_torch.problems import orszag_tang as tot

from test_torch_radiation import _few_threads, close  # noqa: F401

jax.config.update("jax_enable_x64", True)
JMhd = importlib.import_module("castro_tpu.mhd").MhdSimulation
TMhd = importlib.import_module("castro_tpu_torch.mhd").MhdSimulation


def run_both(jp, tp, jinit, tinit, steps, dt_frac=0.5):
    """Both packages' MhdSimulation from the same data, `steps` steps at
    dt_frac of the JAX run's initial CFL dt (the JAX side op by op)."""
    js = JMhd(jp, problem_init=jinit)
    ts = TMhd(tp, problem_init=tinit, device="cpu")
    with jax.disable_jit():
        js.init_data()
        ts.init_data()
        dt = dt_frac * float(js._jit_estdt(js.state.u, js.state.b))
        assert abs(ts.estdt() * dt_frac - dt) <= 1e-12 * dt
        for _ in range(steps):
            js.state = js._jit_step(js.state, dt)
            ts.state = ts.step(ts.state, dt)
    return js, ts


def check(js, ts, dtype="float64", divb=1e-11):
    """The interior state and face fields of both packages, and div B."""
    L = ts.base.layout
    ng, dim = ts.base.ng, L.dim
    close(ts.interior(), np.asarray(js.interior()), dtype, "u",
          vectors=[(L.UMX, L.UMY, L.UMZ)])
    isl = (slice(ng, -ng),) * dim
    close(torch.stack([bb[isl] for bb in ts.state.b]),
          np.stack([np.asarray(bb)[isl] for bb in js.state.b]), dtype, "face B",
          vectors=[(0, 1, 2)])
    assert ts.div_b_max() < divb, ts.div_b_max()


STEPS_1D = [("ctu_ppm", dict(mhd_ctu=1)), ("ctu_plm_char", dict(mhd_ctu=1, ppm_type=0)),
            ("ctu_plm_prim", dict(mhd_ctu=1, ppm_type=0, mhd_limit_characteristic=0)),
            ("rk2", dict(mhd_ctu=0))]


@pytest.mark.parametrize("name,castro", STEPS_1D, ids=[s[0] for s in STEPS_1D])
def test_brio_wu_1d(name, castro):
    js, ts = run_both(jmt.brio_wu_params(n=64).with_ns("castro", **castro),
                      tmt.brio_wu_params(n=64).with_ns("castro", **castro),
                      jmt.tube_init(), tmt.tube_init(), steps=6)
    check(js, ts)


STEPS_2D = [("ctu_plm_char", dict(mhd_ctu=1, ppm_type=0), "float64"),
            ("rk2", dict(mhd_ctu=0), "float64")]


def orszag_tang_2d(castro, dtype):
    steps = 1 if dtype == "float32" else 3
    js, ts = run_both(jot.make_params(n=32, dtype=dtype).with_ns("castro", **castro),
                      tot.make_params(n=32, dtype=dtype).with_ns("castro", **castro),
                      jot.problem_init, tot.problem_init, steps=steps)
    check(js, ts, dtype, divb=1e-11 if dtype == "float64" else 1e-4)


@pytest.mark.parametrize("name,castro,dtype", STEPS_2D, ids=[s[0] for s in STEPS_2D])
def test_orszag_tang_2d(name, castro, dtype):
    orszag_tang_2d(castro, dtype)
