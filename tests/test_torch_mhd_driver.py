"""MHD through the port's `Simulation` (castro.do_mhd=1:
`_mhd_step_impl`, the MHD branches of init_data, estimate_dt, try_step and
the retry) against the JAX package's `Simulation` (tests/test_mhd_driver.py's
setups): `run` on the 3D Alfven wave (dt from the MHD estdt), constant
gravity accelerating a uniform magnetized gas at g t (the old source traced
into the CTU-CT states and the corrector), the RK2 step through `Simulation`,
and the fast-magnetosonic dt of tests/test_mhd.py:test_mhd_estdt_used_by_run.
Also what still raises: the CT register data of the RK2 step (AMR takes
CTU-CT) and MHD on a device mesh (queue 1 item 13).

The JAX side runs op by op (`jax.disable_jit()`). Tolerance: float64
1e-10 |jax| + 1e-10 max|jax| per state component, the momenta and the face
fields each sharing their vector's largest magnitude; div B below 1e-11.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems.util import fill_from_prim as jfill

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems.util import fill_from_prim as tfill

from test_torch_radiation import _few_threads, close  # noqa: F401

jax.config.update("jax_enable_x64", True)


def params(P, n=8, dim=3, **castro):
    p = P().with_ns("amr", n_cell=(n,) * dim)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", do_mhd=1, lo_bc=(0,) * dim, hi_bc=(0,) * dim, **castro)
    return p.with_ns("eos", eos_gamma=5.0 / 3.0).with_ns("tpu", dtype="float64")


def alfven(xp, fill):
    """tests/test_mhd_driver.py:_alfven_init in either package (xp: jnp or
    torch, fill: its fill_from_prim)."""
    def init(sim, u, b):
        rho0, p0, B0, amp = 1.0, 0.1, 1.0, 1e-3
        vA = B0 / np.sqrt(rho0)
        shape = tuple(u.shape[1:])
        ph = 2 * np.pi * sim.geom.cell_centers(0, sim.ng)
        z = xp.zeros(shape, dtype=u.dtype) if xp is torch else jnp.zeros(shape)

        def full(a):
            return (a + z) if xp is torch else jnp.broadcast_to(a, shape)

        u = fill(sim, u, rho0, (z, full(amp * vA * xp.cos(ph)), full(amp * vA * xp.sin(ph))), p=p0)
        return u, (z + B0, full(-amp * B0 * xp.cos(ph)), full(-amp * B0 * xp.sin(ph)))
    return init


def uniform(xp, fill):
    """A uniform gas in a uniform field along x (no MHD forces)."""
    def init(sim, u, b):
        shape = tuple(u.shape[1:])
        u = fill(sim, u, 1.0, (0.0, 0.0, 0.0), p=1.0)
        z = xp.zeros(shape, dtype=u.dtype) if xp is torch else jnp.zeros(shape)
        return u, (z + 0.3, z, z)
    return init


def both(n=8, dim=3, init="alfven", **castro):
    make = {"alfven": alfven, "uniform": uniform}[init]
    js = JSim(params(JParams, n, dim, **castro), problem_init=make(jnp, jfill))
    ts = Simulation(params(Params, n, dim, **castro), problem_init=make(torch, tfill),
                    device="cpu")
    with jax.disable_jit():
        js.init_data()
    ts.init_data()
    return js, ts


def check(js, ts):
    L = ts.layout
    close(ts.interior(), np.asarray(js.interior()), what="u", vectors=[(L.UMX, L.UMY, L.UMZ)])
    isl = (slice(ts.ng, -ts.ng),) * L.dim
    close(torch.stack([bb[isl] for bb in ts.u_b]),
          np.stack([np.asarray(bb)[isl] for bb in js.u_b]), what="face B", vectors=[(0, 1, 2)])
    div = ts.mhd.div_b(ts.u_b)[isl]
    assert float(div.abs().max()) < 1e-11


def test_driver_mhd_run_and_divb():
    """Simulation.run drives the CTU-CT MHD step with dt from the MHD
    estdt, as the JAX package's Simulation does."""
    js, ts = both()
    assert ts.mhd is not None and ts.u_b is not None
    check(js, ts)
    with jax.disable_jit():
        js.run(max_step=2, verbose=False)
    ts.run(max_step=2, verbose=False)
    assert ts.step_count == 2 and abs(ts.t - js.t) <= 1e-12 * js.t
    check(js, ts)


def test_driver_mhd_constant_gravity_source():
    """Constant gravity accelerates a uniform magnetized gas at exactly g t
    (periodic box), in both packages alike."""
    g0 = -2.0
    jp = params(JParams, do_grav=1).with_ns("gravity", gravity_type="ConstantGrav", const_grav=g0)
    tp = params(Params, do_grav=1).with_ns("gravity", gravity_type="ConstantGrav", const_grav=g0)
    js = JSim(jp, problem_init=uniform(jnp, jfill))
    ts = Simulation(tp, problem_init=uniform(torch, tfill), device="cpu")
    with jax.disable_jit():
        js.init_data()
        ts.init_data()
        for _ in range(3):
            js.advance(1e-3)
            ts.advance(1e-3)
    check(js, ts)
    w = ts.interior()[ts.layout.UMZ].numpy()
    assert np.allclose(w, g0 * 3 * 1e-3, rtol=1e-6)


def test_driver_mhd_rk2_2d():
    """castro.mhd_ctu=0 through Simulation (2D Alfven wave along x)."""
    js, ts = both(n=16, dim=2, mhd_ctu=0)
    with jax.disable_jit():
        js.run(max_step=2, verbose=False)
    ts.run(max_step=2, verbose=False)
    check(js, ts)
    with pytest.raises(ValueError, match="CTU-CT"):
        ts._mhd_step_impl(ts.u, ts.u_b, 1e-3, keep_ct=True)


def test_mhd_estdt_used_by_run():
    """The fast-magnetosonic CFL dt (tests/test_mhd.py:
    test_mhd_estdt_used_by_run): B = 2 along x, rho 1, gamma p = 1/6, in
    both packages' MhdSimulation and through Simulation.estimate_dt."""
    from castro_tpu.mhd import MhdSimulation as JM

    from castro_tpu_torch.mhd import MhdSimulation as TM

    def init(xp, fill):
        def f(sim, u, b):
            shape = tuple(u.shape[1:])
            base = getattr(sim, "base", sim)
            u = fill(base, u, 1.0, (0.0, 0.0, 0.0), p=0.1)
            z = xp.zeros(shape, dtype=u.dtype) if xp is torch else jnp.zeros(shape)
            return u, (z + 2.0, z, z)
        return f

    p_j = params(JParams, 32, 2).with_ns("castro", cfl=0.4)
    p_t = params(Params, 32, 2).with_ns("castro", cfl=0.4)
    jm = JM(p_j, problem_init=init(jnp, jfill))
    tm = TM(p_t, problem_init=init(torch, tfill), device="cpu")
    jm.init_data()
    tm.init_data()
    dt_j = float(jm.solver.estdt(jm.state.u, jm.state.b, 0.4))
    dt_t = tm.estdt()
    assert abs(dt_t - dt_j) <= 1e-12 * dt_j
    dx = 1.0 / 32
    assert abs(dt_t - 0.4 * dx / np.sqrt(4.0 + 5.0 / 3.0 * 0.1)) / dt_t < 0.05
    ts = Simulation(p_t, problem_init=init(torch, tfill), device="cpu")
    ts.init_data()
    assert abs(ts.estimate_dt() - dt_t * ts.params.castro.init_shrink) <= 1e-12 * dt_t


def test_mhd_on_a_mesh_raises():
    """The distributed MHD step is queue 1 item 13."""
    from castro_tpu_torch.driver.amr import AmrSimulation
    from castro_tpu_torch.problems import orszag_tang

    p = orszag_tang.make_params(n=16).with_ns("amr", max_level=1)
    with pytest.raises(NotImplementedError, match="item 13"):
        AmrSimulation(p, problem_init=orszag_tang.problem_init, mesh=object(), device="cpu")
