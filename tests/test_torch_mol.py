"""The method-of-lines operators of the PyTorch port against the JAX
package on the CPU: `ops/mol.py` (`_plm_interface_states`, `mol_hydro` in
1D, 2D and 3D with the CGF, riemanncg and HLLC solvers on Cartesian grids,
and on a 2D RZ and a 1D spherical grid) and every function of
`ops/fourth_order.py`, `mol4_hydro` among them; the kernel route of the MOL
Riemann solves (the cmpflx kernel's plain version on the CPU) against the
torch-op route; and SDC-4 on an RZ grid raising where the JAX package
asserts.

Both packages take the same seeded state (numpy, float64). The JAX side
runs op by op (`jax.disable_jit()`). Tolerance, interiors only: rtol 1e-10
with an absolute floor of 1e-10 times each component's largest magnitude.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.ops import advection_util as jau
from castro_tpu.ops import fourth_order as j4
from castro_tpu.ops import mol as jmol
from castro_tpu.problems import sedov as jsedov
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import fourth_order as t4
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops import mol as tmol
from castro_tpu_torch.problems import sedov

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
N = {1: 24, 2: 12, 3: 6}
# name -> (dim, coord, riemann_solver)
MOL_CASES = {
    "1d-cgf": (1, 0, 0), "1d-cg": (1, 0, 1), "1d-hllc": (1, 0, 2),
    "2d-cgf": (2, 0, 0), "2d-cg": (2, 0, 1), "2d-hllc": (2, 0, 2),
    "3d-cgf": (3, 0, 0), "3d-cg": (3, 0, 1), "3d-hllc": (3, 0, 2),
    "2d-rz": (2, 1, 0), "1d-spherical": (1, 2, 0),
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(mod, dim, coord=0, **castro):
    p = mod.make_params(n=N[dim], dim=dim, coord=coord, prob_hi=1.0)
    if coord == 1:
        p = p.with_ns("geometry", prob_lo=(0.0, -0.5, 0.0), prob_hi=(1.0, 0.5, 0.0))
    return p.with_ns("castro", **castro) if castro else p


def _sims(dim, coord=0, **castro):
    """The JAX and the port's Simulation of one configuration (Sedov's
    layout: one species, gamma law 1.4)."""
    js = JSim(_params(jsedov, dim, coord, **castro), problem_init=jsedov.problem_init)
    ts = Simulation(_params(sedov, dim, coord, **castro), problem_init=sedov.problem_init,
                    device="cpu")
    return js, ts


def _state(L, shape, seed, smooth=False):
    """A seeded conserved state (float64 numpy) on the grown grid: density
    0.5-1.5, velocities within 0.5, pressure 0.5-2 (gamma law 1.4). With
    `smooth`, smooth fields (sines of the cell index) instead of noise."""
    rng = np.random.default_rng(seed)
    if smooth:
        idx = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
        ph = rng.uniform(0, 2 * np.pi, 8)

        def field(k, lo, hi):
            s = sum(np.sin(2 * np.pi * x / 11.0 * (1 + d) + ph[k]) for d, x in enumerate(idx))
            return lo + (hi - lo) * 0.5 * (1 + s / len(idx))
    else:
        def field(k, lo, hi):
            return rng.uniform(lo, hi, shape)
    rho = field(0, 0.5, 1.5)
    vel = [field(1 + d, -0.5, 0.5) for d in range(3)]
    p = field(4, 0.5, 2.0)
    u = np.zeros((L.NVAR,) + tuple(shape))
    u[L.URHO] = rho
    for d, c in enumerate((L.UMX, L.UMY, L.UMZ)):
        u[c] = rho * vel[d]
    u[L.UEINT] = p / 0.4
    u[L.UEDEN] = u[L.UEINT] + 0.5 * rho * sum(v * v for v in vel)
    u[L.UTEMP] = 1.0
    u[L.UFS] = rho
    return u


def _inner(a, ng, dim):
    a = np.asarray(a, np.float64)
    return a[(slice(None),) * (a.ndim - dim) + (slice(ng, -ng),) * dim]


def _close(got, ref, ng, dim, what, rtol=RTOL):
    got, ref = _inner(got, ng, dim), _inner(ref, ng, dim)
    assert got.shape == ref.shape, what
    flat = ref.reshape(ref.shape[0], -1) if ref.ndim > dim else ref.reshape(1, -1)
    scale = np.abs(flat).max(1).reshape((-1,) + (1,) * dim) if ref.ndim > dim \
        else np.abs(flat).max()
    np.testing.assert_array_less(np.abs(got - ref), rtol * (np.abs(ref) + scale) + 1e-300,
                                 err_msg=what)


def _prims(js, ts, u):
    """q, qaux of both packages from the same conserved state."""
    jq, jqa = jau.ctoprim(u, js.layout, js.eos, js.cfg.small_dens, 1e-12)
    tu = torch.as_tensor(u)
    tq, tqa = au.ctoprim(tu, ts.layout, ts.eos, ts.cfg.small_dens, ts.small_temp)
    return (jq, jqa), (tu, tq, tqa)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_plm_interface_states(dim, order):
    js, ts = _sims(dim)
    u = _state(ts.layout, ts.grown_shape(), seed=dim)
    (jq, _), (_, tq, _) = _prims(js, ts, u)
    with jax.disable_jit():
        jf = jax.numpy.asarray(np.random.default_rng(5).uniform(0.0, 1.0, ts.grown_shape()))
        for d in range(dim):
            jm, jp = jmol._plm_interface_states(jq, jf, d, js.layout, order)
            tm, tp = tmol._plm_interface_states(tq, torch.as_tensor(np.asarray(jf)), d,
                                                ts.layout, order)
            _close(tm, jm, ts.ng, dim, f"qm d={d}")
            _close(tp, jp, ts.ng, dim, f"qp d={d}")


@pytest.mark.parametrize("case", list(MOL_CASES))
def test_mol_hydro(case):
    """A(U), the face fluxes and the Godunov states of mol_hydro, the port's
    solves on its kernel route (the cmpflx kernel's plain version; riemanncg
    in torch ops)."""
    dim, coord, solver = MOL_CASES[case]
    js, ts = _sims(dim, coord, riemann_solver=solver)
    assert ts.cfg.use_kernels
    u = _state(ts.layout, ts.grown_shape(), seed=10 + dim)
    if coord:
        # positive radial velocity everywhere near the axis keeps the
        # curvilinear pdivu term well away from a cancellation
        u[ts.layout.UMX] = np.abs(u[ts.layout.UMX])
        u[ts.layout.UEDEN] = u[ts.layout.UEINT] + 0.5 * sum(
            u[c] ** 2 for c in (ts.layout.UMX, ts.layout.UMY, ts.layout.UMZ)) / u[0]
    (jq, jqa), (tu, tq, tqa) = _prims(js, ts, u)
    K.reset_launch_counts()
    with jax.disable_jit():
        jadv, jfl, jqe = jmol.mol_hydro(jax.numpy.asarray(u), jq, jqa, 0.0, js.geom,
                                        js.layout, js.cfg)
    tadv, tfl, tqe = tmol.mol_hydro(tu, tq, tqa, 0.0, ts.geom, ts.layout, ts.cfg)
    assert all(v == 0 for v in K.launch_counts().values())  # the CPU: plain versions
    _close(tadv, jadv, ts.ng, dim, "adv")
    for d in range(dim):
        _close(tfl[d], jfl[d], ts.ng, dim, f"flux d={d}")
        _close(tqe[d], jqe[d], ts.ng, dim, f"qe d={d}")


def _fo_inputs(dim, seed):
    js, ts = _sims(dim)
    u = _state(ts.layout, ts.grown_shape(), seed=seed, smooth=True)
    return js, ts, u


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_fourth_order_conversions(dim):
    """lap2, the cell and face average/centre conversions, fourth_interface
    and face_center_to_avg_correction, every direction."""
    js, ts, u = _fo_inputs(dim, 20 + dim)
    ju, tu = jax.numpy.asarray(u), torch.as_tensor(u)
    ng = ts.ng
    with jax.disable_jit():
        for axis in range(1, dim + 1):
            _close(t4.lap2(tu, axis), j4.lap2(ju, axis), ng, dim, f"lap2 {axis}")
        _close(t4.cell_avg_to_center(tu, dim), j4.cell_avg_to_center(ju, dim), ng, dim,
               "cell_avg_to_center")
        _close(t4.cell_center_to_avg(tu, dim), j4.cell_center_to_avg(ju, dim), ng, dim,
               "cell_center_to_avg")
        for d in range(dim):
            _close(t4.fourth_interface(tu, d), j4.fourth_interface(ju, d), ng, dim,
                   f"fourth_interface {d}")
            _close(t4.face_avg_to_center(tu, d, dim), j4.face_avg_to_center(ju, d, dim), ng,
                   dim, f"face_avg_to_center {d}")
            if dim > 1:
                _close(t4.face_center_to_avg_correction(tu, d, dim),
                       j4.face_center_to_avg_correction(ju, d, dim), ng, dim,
                       f"face_center_to_avg_correction {d}")
            else:
                assert not t4.face_center_to_avg_correction(tu, d, dim).any()


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_fourth_avisc(dim):
    js, ts, u = _fo_inputs(dim, 30 + dim)
    # a compressive band, so the switch is on in places and off elsewhere
    u[ts.layout.UMX] -= 0.8 * u[ts.layout.URHO] * np.sin(
        np.linspace(0, 3 * np.pi, u.shape[1]))[(slice(None),) + (None,) * (dim - 1)]
    (jq, jqa), (_, tq, tqa) = _prims(js, ts, u)
    with jax.disable_jit():
        for d in range(dim):
            ja = j4.fourth_avisc(jq, jqa, d, dim, js.geom.dx, js.layout)
            ta = t4.fourth_avisc(tq, tqa, d, dim, ts.geom.dx, ts.layout)
            assert (np.asarray(ja) < 0).any()
            _close(ta, ja, ts.ng, dim, f"fourth_avisc {d}")


@pytest.mark.parametrize("solver", [0, 2])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_mol4_hydro(dim, solver):
    js, ts = _sims(dim, riemann_solver=solver)
    u = _state(ts.layout, ts.grown_shape(), seed=40 + dim, smooth=True)
    with jax.disable_jit():
        jadv, jfl, jqe = j4.mol4_hydro(jax.numpy.asarray(u), js.geom, js.layout, js.cfg,
                                       js.eos, 1e-12)
    tadv, tfl, tqe = t4.mol4_hydro(torch.as_tensor(u), ts.geom, ts.layout, ts.cfg, ts.eos,
                                   ts.small_temp)
    _close(tadv, jadv, ts.ng, dim, "adv")
    for d in range(dim):
        _close(tfl[d], jfl[d], ts.ng, dim, f"flux d={d}")
        _close(tqe[d], jqe[d], ts.ng, dim, f"qe d={d}")


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_route_of_the_solves(dim, order):
    """The MOL operators with their solves on the kernel route (the cmpflx
    kernel's plain version on CPU tensors) against the torch-op route of
    riemann.cmpflx: the same faces, the same solve, equal results."""
    _, ts = _sims(dim)
    u = torch.as_tensor(_state(ts.layout, ts.grown_shape(), seed=50 + dim, smooth=True))
    outs = []
    for use_kernels in (True, False):
        cfg = ts.cfg._replace(use_kernels=use_kernels)
        if order == 2:
            q, qaux = au.ctoprim(u, ts.layout, ts.eos, cfg.small_dens, ts.small_temp)
            outs.append(tmol.mol_hydro(u, q, qaux, 0.0, ts.geom, ts.layout, cfg))
        else:
            outs.append(t4.mol4_hydro(u, ts.geom, ts.layout, cfg, ts.eos, ts.small_temp))
    (ka, kf, kq), (pa, pf, pq) = outs
    _close(ka, pa, ts.ng, dim, "adv", rtol=1e-13)
    for d in range(dim):
        _close(kf[d], pf[d], ts.ng, dim, f"flux d={d}", rtol=1e-13)
        _close(kq[d], pq[d], ts.ng, dim, f"qe d={d}", rtol=1e-13)


@pytest.mark.parametrize("quadrature", [0, 1])
def test_sdc4_on_rz_raises(quadrature):
    """4th-order MOL is Cartesian only: SDC-4 on an RZ grid raises at its
    first evaluation, where the JAX package asserts
    (castro_tpu/ops/fourth_order.py:114-115); SDC-2 runs there."""
    p = _params(sedov, 2, 1, time_integration_method=2, sdc_order=4,
                sdc_quadrature=quadrature)
    sim = Simulation(p, problem_init=sedov.problem_init, device="cpu")
    sim.init_data()
    with pytest.raises(ValueError, match="Cartesian-only"):
        sim.try_step(1e-4)
    sim2 = Simulation(_params(sedov, 2, 1, time_integration_method=2),
                      problem_init=sedov.problem_init, device="cpu")
    sim2.init_data()
    u, status = sim2.try_step(1e-4)
    assert status.success and bool(torch.isfinite(u).all())
