"""PLM (`ppm_type=0`): the port's `ops/slope.py` and `ops/trace_plm.py`
against the JAX package, and the PLM step in 3D (the kernel structure the
JAX package runs on its accelerator: flatten kernel, the torch-op trace,
`ctu_face` with terms=[] x3 for the 1D solves, the paired corner stages and
the finals with consup; plain versions on the CPU) and in 2D against the
JAX XLA path on the CPU.

Also the helpers the other new test files share: the JAX reference states
of a step sequence, the port held against them step by step, and a count
of the kernel wrappers a step calls (on the CPU a wrapper runs its plain
version and counts no launch, so the test counts the calls).

Tolerances as the other test_torch_* files: float64 rtol 1e-10 (plus 1e-10
of each component's largest magnitude; slopes and traces of random states
at rtol 1e-12); float32 rtol = atol = 2e-5 (tests/test_pallas.py:41);
interiors only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.ops import slope as jslope
from castro_tpu.ops.trace_plm import trace_plm as j_trace_plm
from castro_tpu.problems import sedov as jsedov
from castro_tpu.state import StateLayout as JLayout

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops import slope
from castro_tpu_torch.ops.trace_plm import trace_plm
from castro_tpu_torch.problems import sedov
from castro_tpu_torch.state import StateLayout

from test_torch_hydro_paths import _assert_close, _few_threads  # noqa: F401

KERNEL_NAMES = ("prim_aux", "flatten", "trace_ppm", "ctu_face", "clean_fill", "cmpflx",
                "trans_apply", "trans_cmpflx", "consup")


def jax_states(make_jsim, dtype, steps, dt, use_pallas=False):
    """The JAX package's states [initial, after step 1, ...] as numpy, with
    jit disabled (op by op, which compiles once per shape)."""
    with jax.disable_jit():
        js = make_jsim()
        if use_pallas:
            js.cfg = js.cfg._replace(use_pallas=True)
            js._use_fused_prim = js.layout.dim == 3
        js.init_data()
        states = [np.asarray(js.u)]
        for k in range(steps):
            u, _, bad = js._step_impl(js.u, np.dtype(dtype).type(dt), k * dt)
            assert not bool(bad)
            js.u = u
            states.append(np.asarray(u))
    return states


def port_matches(sim, states, dtype, dt):
    """Step the port's `sim` from states[0] with the same dt and hold every
    step's interior against `states`. Returns the final state."""
    sim.init_data()
    ng, dim = sim.ng, sim.layout.dim
    inner = (slice(None),) + (slice(ng, -ng),) * dim
    if dtype == "float64":
        _assert_close(sim.interior(), states[0][inner], dtype, "init")
    u = convert.state_from_numpy(states[0], sim.layout, "cpu", sim.dtype)
    for k in range(len(states) - 1):
        u, min_rho, bad = sim._step_impl(u, dt, k * dt)
        assert not bool(bad) and float(min_rho) > 0.0
        _assert_close(sim.interior(u), states[k + 1][inner], dtype, f"step {k + 1}")
    return u


@pytest.fixture
def calls(monkeypatch):
    """{kernel: calls of its wrapper} while the test runs."""
    counts = {name: 0 for name in KERNEL_NAMES}
    for name in KERNEL_NAMES:
        fn = getattr(K, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(K, name, counted)
    return counts


def step_calls(sim, calls):
    """The wrapper calls of one step of `sim` (after init)."""
    sim.init_data()
    for k in calls:
        calls[k] = 0
    sim._step_impl(sim.u, 1e-3)
    return {k: v for k, v in calls.items() if v}


def _sedov(mod, dim, n, dtype, **castro):
    p = mod.make_params(n=n, dim=dim, stop_time=0.1, r_init=0.2, dtype=dtype)
    return p.with_ns("castro", **castro) if castro else p


def _random_prims(shape, seed):
    rng = np.random.default_rng(seed)
    L = StateLayout(dim=len(shape), nspec=1)
    q = np.zeros((L.NQ,) + shape)
    q[L.QRHO] = rng.uniform(0.5, 1.5, shape)
    q[L.QU:L.QW + 1] = rng.uniform(-0.5, 0.5, (3,) + shape)
    q[L.QPRES] = rng.uniform(0.3, 2.0, shape)
    q[L.QREINT] = q[L.QPRES] / 0.4
    q[L.QGAME] = 1.4
    q[L.QTEMP] = 1.0
    q[L.QFS] = rng.uniform(0.0, 1.0, shape)
    qaux = np.zeros((L.NQAUX,) + shape)
    qaux[L.QGAMC] = 1.4
    qaux[L.QC] = np.sqrt(1.4 * q[L.QPRES] / q[L.QRHO])
    qaux[L.QDPDE] = 0.4
    return q, qaux, rng.uniform(0.5, 1.0, shape), 1e-1 * rng.standard_normal(q.shape)


@pytest.mark.parametrize("order", [2, 4])
def test_uslope_and_pslope_match_jax(order):
    q, _, flatn, src = _random_prims((14, 12, 10), seed=order)
    for ax in range(3):
        np.testing.assert_allclose(
            slope.uslope(torch.as_tensor(q[0]), torch.as_tensor(flatn), ax, order).numpy(),
            np.asarray(jslope.uslope(jnp.asarray(q[0]), jnp.asarray(flatn), ax, order)),
            rtol=1e-12, atol=1e-14)
    for cutoff in (-1e20, 1.0):
        got = slope.pslope(*(torch.as_tensor(a) for a in (q[5], q[0], src[1], flatn)), 0, 0.1,
                           cutoff)
        ref = jslope.pslope(*(jnp.asarray(a) for a in (q[5], q[0], src[1], flatn)), 0, 0.1,
                            cutoff)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("plm_iorder,use_pslope", [(1, False), (2, False), (2, True)],
                         ids=["mc2", "mc4", "mc4-pslope"])
def test_trace_plm_matches_jax(plm_iorder, use_pslope):
    shape = (14, 12, 10)
    q, qaux, flatn, src = _random_prims(shape, seed=10 + plm_iorder)
    JL, TL = JLayout(dim=3, nspec=1), StateLayout(dim=3, nspec=1)
    for d in range(3):
        for s in (None, src):
            kw = dict(plm_iorder=plm_iorder, use_pslope=use_pslope,
                      pslope_cutoff_density=0.9)
            ref = j_trace_plm(jnp.asarray(q), jnp.asarray(qaux),
                              None if s is None else jnp.asarray(s), jnp.asarray(flatn), d,
                              1e-3, 0.1, JL, 1e-12, 1e-20, **kw)
            got = trace_plm(torch.as_tensor(q), torch.as_tensor(qaux),
                            None if s is None else torch.as_tensor(s), torch.as_tensor(flatn),
                            d, 1e-3, 0.1, TL, 1e-12, 1e-20, **kw)
            for g_, r_ in zip(got, ref):
                np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=1e-12, atol=1e-14)


# name -> (dim, n, castro overrides, dtype, steps)
CASES = {
    "3d-f64": (3, 8, dict(ppm_type=0), "float64", 2),
    "3d-f32": (3, 8, dict(ppm_type=0), "float32", 2),
    "3d-mc2-symmetry": (3, 8, dict(ppm_type=0, plm_limiter=1, lo_bc=(3, 3, 3),
                                   hi_bc=(3, 3, 3)), "float64", 2),
    "2d-f64": (2, 16, dict(ppm_type=0), "float64", 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plm_steps_match_jax(case):
    dim, n, castro, dtype, steps = CASES[case]
    dt = 2e-3
    states = jax_states(lambda: JSim(_sedov(jsedov, dim, n, dtype, **castro),
                                     problem_init=jsedov.problem_init), dtype, steps, dt)
    sim = Simulation(_sedov(sedov, dim, n, dtype, **castro), problem_init=sedov.problem_init,
                     device="cpu")
    port_matches(sim, states, dtype, dt)


def test_plm_3d_kernel_structure(calls):
    """A 3D PLM step calls prim_aux, flatten and clean_fill once, no trace
    kernel, and ctu_face nine times (three 1D solves, three corner pairs,
    three finals with consup), as the JAX package launches its kernels."""
    sim = Simulation(_sedov(sedov, 3, 8, "float32", ppm_type=0),
                     problem_init=sedov.problem_init, device="cpu")
    assert step_calls(sim, calls) == {"prim_aux": 1, "flatten": 1, "ctu_face": 9,
                                      "clean_fill": 1}
