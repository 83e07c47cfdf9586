"""Configurations the JAX package honours that the port used to accept and
ignore, on the CPU: the lagged source predictor
(`castro.source_term_predictor=1`) and the point-mass fix
(`castro.point_mass_fix_solution=1`) against the JAX package in float64
(rtol 1e-10 plus 1e-10 of each component's largest magnitude, jit disabled
on the JAX side); the SCF initial model and the I/O cadence, which raise
naming their ROADMAP.md items; and `problem=double_mach` on the command
line.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import sedov as jsedov
from castro_tpu.problems.util import fill_from_prim as jfill

from castro_tpu_torch import __main__ as cli
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import double_mach, sedov
from castro_tpu_torch.problems.util import fill_from_prim

from test_torch_curvilinear import _params as rz_params
from test_torch_hydro_paths import _assert_close, _few_threads  # noqa: F401


def _swirl(mod, xp):
    """RZ Sedov on the axis with an azimuthal velocity 2 r (UMZ carries
    rho v_theta), so that the geometric source moves UMX and UMZ."""
    def init(sim, u):
        u = mod.problem_init(sim, u, center=(0.0, 0.0))
        r = sim.geom.cell_centers(0, sim.ng)
        vth = 2.0 * r * xp.ones_like(u[0])
        rho = u[0]
        if xp is jnp:
            return u.at[3].set(rho * vth).at[4].add(0.5 * rho * vth * vth)
        u = u.clone()
        u[3] = rho * vth
        u[4] = u[4] + 0.5 * rho * vth * vth
        return u
    return init


def _predictor(mod, stp):
    return rz_params(mod, "rz", 8, "float64").with_ns("castro", source_term_predictor=stp)


def test_source_term_predictor_like_jax():
    """2D RZ Sedov with swirl, source_term_predictor=1: the step traces
    S^n + dt/2 dS/dt from the second step on, as in JAX; UMX and UMZ after
    two steps differ from the run without the predictor."""
    dt = 1e-3
    with jax.disable_jit():
        js = JSim(_predictor(jsedov, 1), problem_init=_swirl(jsedov, jnp))
        js.init_data()
        for _ in range(2):
            js.advance(dt)
        ref = np.asarray(js.interior())
    sims = {}
    for stp in (1, 0):
        sims[stp] = Simulation(_predictor(sedov, stp), problem_init=_swirl(sedov, torch),
                               device="cpu")
        sims[stp].init_data()
        for _ in range(2):
            sims[stp].advance(dt)
    assert sims[1]._src_pred is not None and sims[0]._src_pred is None
    _assert_close(sims[1].interior(), ref, "float64", "after two steps with the predictor")
    L = sims[1].layout
    for comp in (L.UMX, L.UMZ):
        assert not torch.equal(sims[1].interior()[comp], sims[0].interior()[comp])


def _converging(xp, fill):
    """A uniform gas flowing into the middle of the box, where the
    2-cell box of the point-mass fix gains mass."""
    def init(sim, u):
        x = sim.geom.cell_centers(0, sim.ng) - 0.5
        y = sim.geom.cell_centers(1, sim.ng) - 0.5
        r = xp.sqrt(x * x + y * y) + 1e-3
        return fill(sim, u, 1.0, (-0.3 * x / r, -0.3 * y / r, 0.0), p=1.0)
    return init


def _point_mass_params(mod):
    p = mod.make_params(n=16, dim=2, dtype="float64")
    return p.with_ns("castro", use_point_mass=1, point_mass_fix_solution=1, point_mass=1.0)


def test_point_mass_fix_like_jax():
    """point_mass_fix_solution=1 on pure hydro: the box about the centre is
    reset to its pre-step state and its mass gain accretes onto the point
    mass, in both packages alike."""
    dt = 5e-3
    with jax.disable_jit():
        js = JSim(_point_mass_params(jsedov), problem_init=_converging(jnp, jfill))
        js.init_data()
        for _ in range(2):
            js.advance(dt)
        ref, ref_pm = np.asarray(js.interior()), js.point_mass
    sim = Simulation(_point_mass_params(sedov), problem_init=_converging(torch, fill_from_prim),
                     device="cpu")
    sim.init_data()
    u0 = sim.interior().clone()
    for _ in range(2):
        sim.advance(dt)
    assert sim.point_mass > 1.0
    assert sim.point_mass == pytest.approx(ref_pm, rel=1e-12)
    _assert_close(sim.interior(), ref, "float64", "after two steps with the point-mass fix")
    box = (slice(6, 10), slice(6, 10))
    assert torch.equal(sim.interior()[(slice(None),) + box], u0[(slice(None),) + box])


def test_scf_initial_model_raises():
    p = sedov.make_params(n=8, dim=2).with_ns("castro", do_scf_initial_model=1)
    with pytest.raises(NotImplementedError, match="item 10"):
        Simulation(p, problem_init=sedov.problem_init, device="cpu")


IO_KEYS = [("amr", "plot_int", 10), ("amr", "check_int", 10), ("castro", "sum_interval", 1),
           ("amr", "data_log", ("log",)), ("tpu", "profile", 1)]


@pytest.mark.parametrize("amr", [False, True], ids=["single-level", "amr"])
@pytest.mark.parametrize("ns,key,value", IO_KEYS, ids=[k for _, k, _ in IO_KEYS])
def test_io_cadence_raises(ns, key, value, amr):
    p = sedov.make_params(n=16, dim=1).with_ns(ns, **{key: value})
    if amr:
        p = p.with_ns("amr", max_level=1)
        sim = AmrSimulation(p, problem_init=sedov.problem_init, device="cpu")
    else:
        sim = Simulation(p, problem_init=sedov.problem_init, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{ns}.{key}.*item 14"):
        sim.run(max_step=1, verbose=False)


def test_double_mach_on_the_command_line(monkeypatch, capsys):
    """`python -m castro_tpu_torch problem=double_mach device=cpu` builds the
    problem with its inflow hook and runs it to its stop time (here at
    32 x 8; its build function ignores overrides, as in the JAX CLI)."""
    build = double_mach.build

    def small(n=(256, 64), dtype="float64", device=None):
        return build(n=(32, 8), dtype=dtype, device=device)

    monkeypatch.setattr(double_mach, "build", small)
    assert cli.main(["problem=double_mach", "device=cpu", "amr.max_step=1"]) == 0
    out = capsys.readouterr().out
    assert "ignored: double_mach sets its own inputs" in out
    last = [ln for ln in out.splitlines() if ln.startswith("STEP")][-1]
    t = float(last.split("t=")[1].split()[0])
    assert math.isclose(t, 0.2, rel_tol=1e-12)
    assert int(last.split()[1]) > 1


def test_amr_on_the_command_line(capsys):
    """amr.max_level=1 takes the AmrSimulation (a 1D Sod, two steps)."""
    assert cli.main(["problem=sod", "device=cpu", "amr.n_cell=32", "amr.max_level=1",
                     "amr.max_step=2", "amr.refinement_indicators=dens",
                     "amr.dens.field=density", "amr.dens.relative_gradient=0.1"]) == 0
    out = capsys.readouterr().out
    assert "refined_cells_l1=" in out and "STEP 2" in out


@pytest.mark.parametrize("change,item", [
    (dict(castro=dict(do_mhd=1), mesh=True), "item 13"),
    (dict(amr=dict(distribute_fine=1)), "item 13"),
    (dict(mesh=True), "item 13"),
    (dict(geometry=dict(coord_sys=1)), "item 5"),
    (dict(tag="soundspeed"), "item 14"),
], ids=["mhd", "distribute_fine", "mesh", "curvilinear", "derived-tag-field"])
def test_amr_features_not_ported_raise(change, item):
    """What the JAX AMR driver does beyond the port's Cartesian hydro
    raises, naming its ROADMAP.md item."""
    p = sedov.make_params(n=16, dim=2).with_ns("amr", max_level=1)
    for ns in ("castro", "amr", "geometry"):
        if ns in change:
            p = p.with_ns(ns, **change[ns])
    if "tag" in change:
        p = p.with_ns("amr", refinement_indicators=("t",)).replace(
            extra={"amr.t.field": change["tag"], "amr.t.value_greater": 1.0})
    with pytest.raises(NotImplementedError, match=item):
        amr = AmrSimulation(p, problem_init=sedov.problem_init, device="cpu",
                            mesh=object() if "mesh" in change else None)
        amr.init_data()
