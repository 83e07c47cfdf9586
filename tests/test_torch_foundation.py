"""Foundations of the PyTorch port against the JAX package: state layout,
Params from one inputs text, geometry, `shifted`, the gamma-law EOS, the
device rules, and that the port loads neither JAX nor the JAX package.

Tolerance: float64, rtol = 1e-12 (the same arithmetic)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from castro_tpu import config as jconfig
from castro_tpu import geometry as jgeometry
from castro_tpu import state as jstate
from castro_tpu.eos.gamma_law import GammaLawEos as JGammaLaw
from castro_tpu.network.general_null import GeneralNullNetwork as JNull
from castro_tpu.ops.stencil import shifted as jshifted

from castro_tpu_torch import config as tconfig
from castro_tpu_torch import convert
from castro_tpu_torch import geometry as tgeometry
from castro_tpu_torch import state as tstate
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.network import GeneralNullNetwork
from castro_tpu_torch.ops.stencil import interior_slice, shifted

RTOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _props(obj):
    cls = type(obj)
    return {n: getattr(obj, n) for n in dir(cls)
            if isinstance(getattr(cls, n, None), property)}


@pytest.mark.parametrize("kw", [
    dict(dim=3, nspec=1), dict(dim=2, nspec=3, naux=2),
    dict(dim=3, nspec=2, shock_var=True, hybrid_momentum=True),
    dict(dim=3, nspec=1, mhd=True), dict(dim=1, nspec=4, radiation=True, ngroups=3)],
    ids=["sedov", "aux", "shock-hybrid", "mhd", "radiation"])
def test_layout_indices_match(kw):
    j, t = jstate.StateLayout(**kw), tstate.StateLayout(**kw)
    assert _props(j) == _props(t)
    assert all(j.momentum_index(d) == t.momentum_index(d) for d in range(3))


INPUTS = """
# a Castro inputs file
amr.n_cell = 64 32 16
amr.max_step = 20
max_step = 30
stop_time = 0.25
geometry.prob_hi = 2.0 1.0 0.5
castro.lo_bc = 3 2 0
castro.hi_bc = 2 2 0
castro.riemann_solver = 2
castro.cfl = 0.4
castro.small_dens = 1.e-10
eos.eos_gamma = 1.6667
problem.r_init = 0.05
tpu.dtype = float64
castro.unknown_knob = 7
"""


def test_params_from_inputs_text_match(tmp_path):
    j = jconfig.parse_inputs_text(INPUTS)
    t = convert.params_from_inputs_text(INPUTS)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    path = tmp_path / "inputs"
    path.write_text(INPUTS)
    assert dataclasses.asdict(tconfig.load_inputs(str(path))) == \
        dataclasses.asdict(jconfig.load_inputs(str(path)))
    assert t.amr.max_step == 30 and t.castro.lo_bc == (3, 2, 0) and t.dim == 3
    assert t.extra == {"castro.unknown_knob": 7}


@pytest.mark.parametrize("coord,dim", [(0, 3), (1, 2), (2, 1)],
                         ids=["cartesian", "cylindrical", "spherical"])
def test_geometry_matches(coord, dim):
    kw = dict(dim=dim, coord=coord, prob_lo=(0.0,) * dim, prob_hi=(2.0, 1.0, 0.5)[:dim],
              n_cell=(12, 8, 6)[:dim])
    j = jgeometry.Geometry(**{**kw, "coord": jgeometry.CoordSys(coord)}, dtype=jnp.float64)
    t = tgeometry.Geometry(**{**kw, "coord": tgeometry.CoordSys(coord)}, dtype=torch.float64)
    assert j.dx == t.dx
    for ng in (0, 4):
        np.testing.assert_allclose(t.volume(ng).numpy(), np.asarray(j.volume(ng)), rtol=RTOL)
        np.testing.assert_allclose(t.radius(ng).numpy(), np.asarray(j.radius(ng)), rtol=RTOL)
        for d in range(dim):
            np.testing.assert_allclose(t.face_area(d, ng).numpy(),
                                       np.asarray(j.face_area(d, ng)), rtol=RTOL)
            np.testing.assert_allclose(t.cell_centers(d, ng).numpy(),
                                       np.asarray(j.cell_centers(d, ng)), rtol=RTOL)


def test_shifted_and_interior_match():
    a = np.random.default_rng(0).standard_normal((2, 7, 6, 5))
    for axis in (1, 2, 3):
        for off in (-3, -2, -1, 0, 1, 2, 3):
            np.testing.assert_array_equal(shifted(torch.as_tensor(a), off, axis).numpy(),
                                          np.asarray(jshifted(jnp.asarray(a), off, axis)))
    assert a[interior_slice(1, 3)].shape == (2, 5, 4, 3)


@pytest.mark.parametrize("neutral", [True, False])
def test_gamma_law_eos_matches(neutral):
    rng = np.random.default_rng(1)
    rho = rng.uniform(0.1, 10.0, (5, 4))
    e = rng.uniform(0.1, 10.0, (5, 4))
    x = rng.uniform(0.0, 1.0, (3, 5, 4))
    xn = x / x.sum(0)
    names = ("He4", "C12", "O16")
    j = JGammaLaw(1.4, network=JNull(names), assume_neutral=neutral)
    t = GammaLawEos(1.4, network=GeneralNullNetwork(names), assume_neutral=neutral)
    T = torch.as_tensor
    for mode, args in (("re", (rho, e)), ("rt", (rho, 1e8 * e)), ("rp", (rho, 0.4 * rho * e))):
        js = getattr(j, mode)(jnp.asarray(args[0]), jnp.asarray(args[1]), jnp.asarray(xn))
        ts = getattr(t, mode)(T(args[0]), T(args[1]), T(xn))
        for field in ("p", "e", "T", "cs", "gam1", "dpdr_e", "dpde", "cv"):
            np.testing.assert_allclose(getattr(ts, field).numpy(),
                                       np.broadcast_to(np.asarray(getattr(js, field)), rho.shape),
                                       rtol=RTOL, err_msg=f"{mode} {field}")


def test_state_from_numpy_checks_components():
    L = tstate.StateLayout(dim=3, nspec=1)
    u = np.zeros((L.NVAR, 4, 4, 4))
    assert convert.state_from_numpy(u, L, "cpu", torch.float32).dtype == torch.float32
    with pytest.raises(ValueError):
        convert.state_from_numpy(u[:-1], L, "cpu", torch.float32)


def test_device_rules_and_unported_configs():
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import sedov

    params = sedov.make_params(n=8, dim=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Simulation(params, problem_init=sedov.problem_init)
    # 3D operator-split radiation (the CTU kernels keep the hydro layout:
    # queue 1 item 9)
    for bad in (params.with_ns("castro", do_radiation=1).with_ns("radiation",
                                                                 hydro_coupling=0),):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Simulation(bad, device="cpu")
    # the 1D and 2D branches, riemanncg, the HLL hybrid, curvilinear
    # geometry, PLM, the shock flag, hybrid momenta, reactions, gravity,
    # the sponge, rotation, thermal diffusion, the NSE bypass, SDC,
    # radiation (the characteristic step in 3D, gray and multigroup; the
    # operator-split step in 2D), do_hydro=0 and MHD are ported
    for good in (sedov.make_params(n=8, dim=2), sedov.make_params(n=8, dim=1),
                 params.with_ns("castro", do_mhd=1),
                 params.with_ns("castro", do_mhd=1, mhd_ctu=0),
                 params.with_ns("castro", time_integration_method=2),
                 params.with_ns("castro", time_integration_method=2, sdc_order=4,
                                sdc_quadrature=1),
                 params.with_ns("castro", time_integration_method=3, do_react=1).with_ns(
                     "network", network_name="iso7"),
                 params.with_ns("castro", riemann_solver=1),
                 params.with_ns("castro", hybrid_riemann=1),
                 sedov.make_params(n=8, dim=2, coord=1),
                 params.with_ns("castro", ppm_type=0),
                 params.with_ns("castro", hybrid_momentum=1),
                 params.with_ns("castro", use_shock_var=1),
                 params.with_ns("castro", do_react=1).with_ns("network", network_name="iso7"),
                 params.with_ns("castro", do_react=1).with_ns("network", network_name="iso7",
                                                              nse=1),
                 params.with_ns("castro", do_grav=1).with_ns("gravity",
                                                            gravity_type="PoissonGrav"),
                 params.with_ns("castro", do_sponge=1, sponge_lower_density=1e-3,
                                sponge_upper_density=1e-2),
                 params.with_ns("castro", do_rotation=1, rotational_period=1.0),
                 params.with_ns("castro", do_thermal_diffusion=1),
                 params.with_ns("castro", diffuse_temp=1, add_ext_src=1),
                 params.with_ns("castro", do_radiation=1),
                 params.with_ns("castro", do_radiation=1).with_ns(
                     "radiation", ngroups=4, lowest_group_hz=1e13, highest_group_hz=1e17),
                 sedov.make_params(n=8, dim=2).with_ns("castro", do_radiation=1).with_ns(
                     "radiation", hydro_coupling=0),
                 params.with_ns("castro", do_hydro=0)):
        Simulation(good, device="cpu")


def test_port_loads_no_jax():
    """`import castro_tpu_torch` and a CPU step, of Sedov, of the 3D
    DustCollapse (Poisson gravity) and of the multigroup Su & Olson
    (radiation), load neither jax nor any castro_tpu module (a fresh
    process: this one has imported JAX)."""
    code = textwrap.dedent("""
        import sys
        import castro_tpu_torch
        from castro_tpu_torch.driver.sim import Simulation
        from castro_tpu_torch.problems import sedov
        sim = Simulation(sedov.make_params(n=8, dim=3, dtype="float32"),
                         problem_init=sedov.problem_init, device="cpu")
        sim.init_data()
        sim.advance(sim.estimate_dt())
        from castro_tpu_torch.problems import dust_collapse
        grav = Simulation(dust_collapse.make_params(n=8, dim=3, dtype="float32"),
                          problem_init=dust_collapse.problem_init, device="cpu")
        grav.init_data()
        grav.advance(2e-4)
        assert len(grav.source_fns[0].gravity.solve_stats) == 2
        from castro_tpu_torch.problems import su_olson
        rad = Simulation(su_olson.mg_params(n=16), problem_init=su_olson.mg_init, device="cpu")
        rad.init_data()
        su_olson.mg_setup_radiation(rad)
        rad.advance(rad.estimate_dt())
        assert len(rad.rad.solve_stats) > 0
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "jaxlib" or m == "castro_tpu" or m.startswith("castro_tpu.")]
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


@pytest.mark.parametrize("fn", ["enforce_min_density", "normalize_species",
                                "reset_internal_energy", "compute_temp",
                                "enforce_speed_limit", "clean_state"])
def test_clean_ladder_matches(fn):
    """driver/clean.py, each rung and the fused ladder (with a speed
    limit), against the JAX functions on a state with floored, negative
    and fast cells."""
    from castro_tpu.driver import clean as jclean
    from castro_tpu_torch.driver import clean as tclean

    L = tstate.StateLayout(dim=3, nspec=2)
    rng = np.random.default_rng(2)
    shape = (L.NVAR, 6, 5, 4)
    u = rng.uniform(0.5, 2.0, shape)
    u[L.UMX:L.UMZ + 1] = rng.uniform(-3.0, 3.0, (3,) + shape[1:])
    u[L.URHO, 1, 1, 1] = 1e-14
    u[L.UEINT, 2, 2, 2] = -1.0
    u[L.UEDEN, 3, 3, 3] = -5.0
    names = ("He4", "C12")
    j_eos = JGammaLaw(1.4, network=JNull(names))
    t_eos = GammaLawEos(1.4, network=GeneralNullNetwork(names))
    jl = jstate.StateLayout(dim=3, nspec=2)
    args = {
        "enforce_min_density": lambda lay, eos: (lay, 1e-12, 1e-8, eos),
        "normalize_species": lambda lay, eos: (lay,),
        "reset_internal_energy": lambda lay, eos: (lay, eos, 1e-4, 1e-8),
        "compute_temp": lambda lay, eos: (lay, eos, 1e-8),
        "enforce_speed_limit": lambda lay, eos: (lay, 1.5),
        "clean_state": lambda lay, eos: (lay, eos, 1e-12, 1e-8, 1e-4, True, 1.5),
    }[fn]
    ref = getattr(jclean, fn)(jnp.asarray(u), *args(jl, j_eos))
    got = getattr(tclean, fn)(torch.as_tensor(u), *args(L, t_eos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("whole_grid", [True, False])
def test_src_to_prim_and_max_courant_match(whole_grid):
    from castro_tpu.ops import advection_util as jau
    from castro_tpu_torch.ops import advection_util as tau

    L = tstate.StateLayout(dim=3, nspec=1)
    rng = np.random.default_rng(3)
    shape = (5, 6, 7)
    q = rng.uniform(0.5, 2.0, (L.NQ,) + shape)
    q[L.QU:L.QW + 1] -= 1.25
    qaux = rng.uniform(0.5, 2.0, (L.NQAUX,) + shape)
    src = rng.standard_normal((L.NVAR,) + shape)
    T = torch.as_tensor
    jl = jstate.StateLayout(dim=3, nspec=1)
    np.testing.assert_allclose(
        tau.src_to_prim(T(q), T(qaux), T(src), L).numpy(),
        np.asarray(jau.src_to_prim(jnp.asarray(q), jnp.asarray(qaux), jnp.asarray(src), jl)),
        rtol=RTOL)
    kw = dict(dim=3, prob_lo=(0.0,) * 3, prob_hi=(1.0, 2.0, 3.0), n_cell=shape)
    jg = jgeometry.Geometry(coord=jgeometry.CoordSys(0), dtype=jnp.float64, **kw)
    tg = tgeometry.Geometry(coord=tgeometry.CoordSys(0), dtype=torch.float64, **kw)
    got = tau.max_courant(T(q), T(qaux), 1e-2, tg, L, 1, whole_grid=whole_grid)
    ref = jau.max_courant(jnp.asarray(q), jnp.asarray(qaux), 1e-2, jg, jl, 1,
                          whole_grid=whole_grid)
    assert float(got) == pytest.approx(float(ref), rel=RTOL)
