"""The port's `Gravity` (`castro_tpu_torch/gravity/__init__.py`) against the
JAX package's on the CPU: ConstantGrav, MonopoleGrav and PoissonGrav;
multipole BCs of order 0 and 2; direct-sum BCs; a periodic domain; the
point mass (static and run-time); 1D spherical and 2D RZ monopole; and
the port alone against the analytic uniform sphere
(tests/test_gravity.py:30-57's thresholds) and in float32 against float64.

The JAX package's multigrid runs jitted (`jit_jax_poisson`, a wrapper
installed with monkeypatch for the test): its `lax.while_loop` otherwise
compiles its body anew at every call outside jit. The jitted solve is the
same program as the one the JAX step compiles.

Tolerances: float64, g and phi within 1e-10 of their largest magnitude;
the port's float32 against JAX float64 within 1e-4 of the largest
magnitude (tests/test_f32_physics.py's float32-vs-float64 budget); the
same V-cycle count.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.geometry import geometry_from_params as jgeometry
from castro_tpu.gravity import Gravity as JGravity
from castro_tpu.solvers import multigrid as jmg
from castro_tpu.state import layout_from_params as jlayout

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import StepCtx
from castro_tpu_torch.geometry import geometry_from_params
from castro_tpu_torch.gravity import Gravity
from castro_tpu_torch.problems import gravity_tests
from castro_tpu_torch.solvers import multigrid as tmg
from castro_tpu_torch.state import layout_from_params
from castro_tpu_torch.utils import constants as C

jax.config.update("jax_enable_x64", True)

TOL = 1e-10
F32_VS_F64 = 1e-4
N = 16


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make_jit_poisson():
    """A drop-in for castro_tpu.solvers.multigrid.poisson that runs the
    solve as one jitted program (re-enabling jit inside disable_jit), one
    compile per grid, dx and BC kinds."""
    orig = jmg.poisson
    cache = {}

    def poisson(rhs, dx, *, bc_vals_lo=None, bc_vals_hi=None, **static):
        key = (tuple(dx), tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                                       for k, v in static.items())))
        if key not in cache:
            cache[key] = jax.jit(lambda r, bl, bh: orig(r, tuple(dx), bc_vals_lo=bl,
                                                        bc_vals_hi=bh, **static))
        with jax.disable_jit(False):
            return cache[key](rhs, bc_vals_lo, bc_vals_hi)

    return poisson


@pytest.fixture(autouse=True, scope="module")
def jit_jax_poisson():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "poisson", make_jit_poisson())
    yield
    mp.undo()


def _params(P, gtype, lnum=2, direct=0, bc=2, dim=3, dtype="float64", coord=0, n=N, **castro):
    p = P()
    p = p.with_ns("amr", n_cell=(n,) * dim)
    if coord == 0:
        p = p.with_ns("geometry", prob_lo=(-1.0,) * 3, prob_hi=(1.0,) * 3)
        bcs = dict(lo_bc=(bc,) * dim, hi_bc=(bc,) * dim)
    else:  # the axis at r = 0
        p = p.with_ns("geometry", coord_sys=coord, prob_lo=(0.0, -1.0, 0.0),
                      prob_hi=(1.0, 1.0, 1.0))
        bcs = dict(lo_bc=(3,) + (2,) * (dim - 1), hi_bc=(2,) * dim)
    p = p.with_ns("castro", do_grav=1, **bcs, **castro)
    p = p.with_ns("gravity", gravity_type=gtype, max_multipole_order=lnum,
                  direct_sum_bcs=direct, const_grav=-2.5)
    return p.with_ns("tpu", dtype=dtype)


def _rho(dim, coord=0, n=N):
    """An off-centre Gaussian blob on a floor (a sphere about the origin in
    curvilinear geometry), from a seed."""
    rng = np.random.default_rng(11)
    if coord == 0:
        x = (np.arange(n) + 0.5) / n * 2 - 1
        xs = np.meshgrid(*([x] * dim), indexing="ij")
        x0 = (0.3, -0.15, 0.1)[:dim]
        r2 = sum((xs[d] - x0[d]) ** 2 for d in range(dim))
    else:
        r = (np.arange(n) + 0.5) / n
        if dim == 1:
            r2 = r ** 2
        else:
            z = (np.arange(n) + 0.5) / n * 2 - 1
            R, Z = np.meshgrid(r, z, indexing="ij")
            r2 = R ** 2 + Z ** 2
    return np.exp(-r2 / 0.08) + 0.01 + 1e-3 * rng.random(r2.shape)


def _pair(gtype, dtype="float64", **kw):
    jp = _params(JParams, gtype, **kw)
    tp = _params(Params, gtype, dtype=dtype, **kw)
    jg = JGravity(jp, jgeometry(jp), jlayout(jp), 4)
    tg = Gravity(tp, geometry_from_params(tp, device="cpu"), layout_from_params(tp), 4)
    return jg, tg


def _close(got, ref, tol, what):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, (what, err)


CASES = {
    "constant": ("ConstantGrav", {}),
    "monopole": ("MonopoleGrav", {}),
    "poisson-multipole0": ("PoissonGrav", dict(lnum=0)),
    "poisson-multipole2": ("PoissonGrav", dict(lnum=2)),
    "poisson-direct-sum": ("PoissonGrav", dict(lnum=0, direct=1)),
    "poisson-periodic": ("PoissonGrav", dict(bc=0)),
    "monopole-1d-spherical": ("MonopoleGrav", dict(dim=1, coord=2, n=64)),
    "monopole-2d-rz": ("MonopoleGrav", dict(dim=2, coord=1, n=32)),
    "poisson-2d-rz": ("PoissonGrav", dict(dim=2, coord=1, n=32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gravity_matches_jax(case):
    gtype, kw = CASES[case]
    jg, tg = _pair(gtype, **kw)
    rho = _rho(kw.get("dim", 3), kw.get("coord", 0), kw.get("n", N))
    with jax.disable_jit():
        gj, phij = jg.grav_vector(jnp.asarray(rho))
    gt, phit = tg.grav_vector(torch.as_tensor(rho))
    _close(gt, gj, TOL, "g")
    assert (phij is None) == (phit is None)
    if phij is not None:
        _close(phit, phij, TOL, "phi")
        vcycles, rnorm = tg.solve_stats[-1]
        assert len(tg.solve_stats) == 1 and 1 < vcycles < tg.n_vcycles
        # the same V-cycle count: JAX's run-to-tolerance solve of the same
        # problem (the program its step compiles) ends on the port's
        # residual norm, which the port's V-cycle before it did not reach
        rhs = 4.0 * math.pi * C.Gconst * rho
        kind = "periodic" if kw.get("bc") == 0 else "dirichlet"
        kw_b = dict(bc_lo=(kind,) * 3, bc_hi=(kind,) * 3, n_vcycles=jg.n_vcycles)
        bcs_j, bcs_t = {}, {}
        if kind == "dirichlet":
            pick = "_direct_sum_bcs" if kw.get("direct") else "_multipole_bcs"
            with jax.disable_jit():
                bcs_j = dict(zip(("bc_vals_lo", "bc_vals_hi"),
                                 getattr(jg, pick)(jnp.asarray(rho), jg.geom)))
            bcs_t = dict(zip(("bc_vals_lo", "bc_vals_hi"),
                             getattr(tg, pick)(torch.as_tensor(rho), tg.geom)))
        r_jax = float(jmg.poisson(jnp.asarray(rhs), jg.geom.dx, rtol=jg.rtol, **kw_b,
                                  **bcs_j)[1])
        assert abs(r_jax - rnorm) <= 1e-6 * rnorm + 1e-12 * np.abs(rhs).max(), (r_jax, rnorm)
        kw_b["n_vcycles"] = vcycles - 1
        r_before = float(tmg.poisson(torch.as_tensor(rhs), tg.geom.dx, **kw_b, **bcs_t)[1])
        assert rnorm <= tg.rtol * np.abs(rhs).max() < r_before


@pytest.mark.parametrize("runtime", [False, True], ids=["static", "run-time"])
def test_point_mass_matches_jax(runtime):
    """use_point_mass: the static castro.point_mass, or the run-time mass the
    step context carries (point_mass_fix_solution's accretion)."""
    jg, tg = _pair("MonopoleGrav", use_point_mass=1, point_mass=2.0e-3 / C.Gconst)
    rho = _rho(3)
    jctx = tctx = None
    if runtime:
        from castro_tpu.driver.sim import StepCtx as JCtx

        m = 3.5e-3 / C.Gconst
        jctx = JCtx(None, None, None, lambda x: x, jg.geom, point_mass=jnp.asarray(m))
        tctx = StepCtx(None, None, None, tg.geom, point_mass=torch.tensor(m, dtype=torch.float64))
    gj, _ = jg.grav_vector(jnp.asarray(rho), jctx)
    gt, _ = tg.grav_vector(torch.as_tensor(rho), tctx)
    _close(gt, gj, TOL, "g with a point mass")


@pytest.mark.parametrize("gtype", ["PoissonGrav", "MonopoleGrav"])
def test_uniform_sphere_field_analytic(gtype):
    """The port alone: tests/test_gravity.py:30-57's uniform sphere (R = 0.5
    in [-1, 1]^3, 32^3) against the analytic field: mean relative error
    < 5%, max < 25% away from the surface and the centre, pointing inward."""
    n = 32
    p = Params().with_ns("amr", n_cell=(n, n, n)).with_ns(
        "geometry", prob_lo=(-1.0,) * 3, prob_hi=(1.0,) * 3).with_ns(
        "castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), do_grav=1).with_ns(
        "gravity", gravity_type=gtype).with_ns("tpu", dtype="float64")
    geom = geometry_from_params(p, device="cpu")
    grav = Gravity(p, geom, layout_from_params(p), 4)
    x = geom.cell_centers_1d(0, 0).numpy()
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    R = 0.5
    rho = np.where(r < R, 1.0, 0.0)
    M = 4.0 / 3.0 * np.pi * R ** 3
    g3, _ = grav.grav_vector(torch.as_tensor(rho))
    g3 = g3.numpy()
    gmag = np.sqrt((g3 ** 2).sum(axis=0))
    g_exact = np.where(r < R, C.Gconst * M * r / R ** 3, C.Gconst * M / r ** 2)
    mask = (r > 0.25) & ((r < 0.4) | (r > 0.65)) & (r < 0.95)
    rel = np.abs(gmag - g_exact)[mask] / g_exact[mask]
    assert rel.mean() < 0.05 and rel.max() < 0.25, (rel.mean(), rel.max())
    gr = (g3[0] * X + g3[1] * Y + g3[2] * Z) / np.maximum(r, 1e-10)
    assert (gr[mask] < 0).all()


def test_float32_against_jax_float64():
    """The port in float32 (the card's precision) against JAX in float64:
    Poisson with order-2 multipole BCs on the cgs DustCollapse scale (rho
    1e9, 1e9 cm), where rho vol r^2 overflows float32 without the r_ref
    normalization."""
    kw = dict(lnum=2)
    jp = _params(JParams, "PoissonGrav", **kw).with_ns(
        "geometry", prob_lo=(-1.35e9,) * 3, prob_hi=(1.35e9,) * 3)
    tp = _params(Params, "PoissonGrav", dtype="float32", **kw).with_ns(
        "geometry", prob_lo=(-1.35e9,) * 3, prob_hi=(1.35e9,) * 3)
    jg = JGravity(jp, jgeometry(jp), jlayout(jp), 4)
    tg = Gravity(tp, geometry_from_params(tp, device="cpu"), layout_from_params(tp), 4)
    rho = 1e9 * _rho(3)
    with jax.disable_jit():
        gj, phij = jg.grav_vector(jnp.asarray(rho))
    gt, phit = tg.grav_vector(torch.as_tensor(rho, dtype=torch.float32))
    assert gt.dtype == torch.float32 and bool(torch.isfinite(gt).all())
    _close(gt, gj, F32_VS_F64, "g, float32 vs float64")
    _close(phit, phij, F32_VS_F64, "phi, float32 vs float64")


def test_cube_sphere_setup():
    """gravity_tests' uniform sphere (n=32, order-4 multipole BCs) with
    tests/test_gravity_problems.py:14-44's checks on the port: phi up to
    the exterior offset within 5% (median) of the closed form, and the
    centre-to-edge drop within 10%. Its parameters set do_hydro=0, so the
    state is made through a stand-in for the Simulation."""
    from castro_tpu_torch.eos import make_eos
    from castro_tpu_torch.network import make_network

    n = 32
    p = gravity_tests.cube_sphere_params(n=n)
    geom = geometry_from_params(p, device="cpu")
    layout = layout_from_params(p)

    class Shim:
        params, ng = p, 4

    shim = Shim()
    shim.geom, shim.layout = geom, layout
    shim.eos = make_eos(p, make_network(p))
    u = torch.zeros((layout.NVAR,) + (n + 8,) * 3, dtype=torch.float64)
    u = gravity_tests.cube_sphere_init(shim, u)
    rho = u[(layout.URHO,) + (slice(4, -4),) * 3]
    _, phi = Gravity(p, geom, layout, 4).grav_vector(rho)
    phi = phi.numpy()
    x = geom.cell_centers_1d(0, 0).numpy()
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    exact = gravity_tests.sphere_potential_exact(r, 0.5, 1.0)
    sel_out = (r > 0.7) & (r < 1.4)
    off = np.median(phi[sel_out] - exact[sel_out])
    err = np.abs(phi - off - exact) / np.abs(exact)
    assert np.median(err[r < 1.4]) < 0.05, np.median(err[r < 1.4])
    c = n // 2
    drop_num = (phi - off)[c, c, c] - np.interp(0.5, x[c:], (phi - off)[c:, c, c])
    drop_exact = exact.min() - gravity_tests.sphere_potential_exact(np.array([0.5]), 0.5,
                                                                    1.0)[0]
    assert abs(drop_num / drop_exact - 1.0) < 0.1, (drop_num, drop_exact)
