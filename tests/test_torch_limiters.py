"""The flux limiters, `speed_limit` and `transverse_use_eos` against the JAX
package on the CPU.

- `limit_hydro_fluxes_on_small_dens` and `limit_hydro_fluxes_on_large_vel`
  on random states whose fluxes do trip them, Cartesian and RZ;
- clean + fill with `speed_limit`;
- Sedov steps with each option through the port's kernel structure (plain
  versions on the CPU) against the JAX XLA path: with a limiter the 3D
  finals run `ctu_face` without consup and the torch ops clean the fluxes
  and update; with `transverse_use_eos` the step takes the plain
  structure, the JAX package's route for that option;
- the kernel wrappers each configuration's step calls.

Tolerances as the other test_torch_* files: float64 rtol 1e-10 (plus 1e-10
of each component's largest magnitude); float32 rtol = atol = 2e-5
(tests/test_pallas.py:41); interiors only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from castro_tpu.driver import clean as jclean
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.eos.gamma_law import GammaLawEos as JEos
from castro_tpu.geometry import CoordSys as JCoord
from castro_tpu.geometry import Geometry as JGeometry
from castro_tpu.network.general_null import GeneralNullNetwork as JNull
from castro_tpu.ops import advection_util as jau
from castro_tpu.ops.fill import fill_ghosts as j_fill_ghosts
from castro_tpu.problems import sedov as jsedov
from castro_tpu.state import StateLayout as JLayout

from castro_tpu_torch.driver.clean import clean_and_fill
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.geometry import CoordSys, Geometry
from castro_tpu_torch.network import GeneralNullNetwork
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.problems import sedov
from castro_tpu_torch.state import StateLayout

from test_torch_hydro_paths import _few_threads  # noqa: F401
from test_torch_plm import calls, jax_states, port_matches, step_calls  # noqa: F401

NG = 4


def _state(dim, seed, coord=0):
    """Random conserved and primitive states, fluxes large enough to trip
    the limiters, and the geometry, in both packages (f64)."""
    rng = np.random.default_rng(seed)
    shape = (16, 14, 12)[:dim]
    L = StateLayout(dim=dim, nspec=1)
    rho = rng.uniform(0.05, 1.5, shape)
    vel = rng.uniform(-2.0, 2.0, (3,) + shape)
    rhoe = rng.uniform(0.3, 2.0, shape)
    u = np.zeros((L.NVAR,) + shape)
    u[L.URHO] = rho
    u[L.UMX:L.UMZ + 1] = rho * vel
    u[L.UEINT] = rhoe
    u[L.UEDEN] = rhoe + 0.5 * rho * (vel ** 2).sum(0)
    u[L.UTEMP] = 1.0
    u[L.UFS] = rho
    flux = 3.0 * rng.standard_normal((L.NVAR,) + shape)
    kw = dict(dim=dim, prob_lo=(0.0,) * dim, prob_hi=(1.0,) * dim,
              n_cell=tuple(s - 2 * NG for s in shape))
    jg = JGeometry(**kw, coord=JCoord(coord), dtype=jnp.float64)
    tg = Geometry(**kw, coord=CoordSys(coord), dtype=torch.float64)
    return u, flux, jg, tg


def _prims(u, dim):
    jl, tl = JLayout(dim=dim, nspec=1), StateLayout(dim=dim, nspec=1)
    jq, _ = jau.ctoprim(jnp.asarray(u), jl, JEos(1.4, network=JNull()), 1e-12, 1e-12)
    tq, _ = au.ctoprim(torch.as_tensor(u), tl, GammaLawEos(1.4, network=GeneralNullNetwork()),
                       1e-12, 1e-12)
    return jl, tl, jq, tq


@pytest.mark.parametrize("dim,coord", [(3, 0), (2, 0), (2, 1)], ids=["3d", "2d", "2d-rz"])
def test_limiters_match_jax(dim, coord):
    u, flux, jg, tg = _state(dim, seed=dim + 3 * coord, coord=coord)
    jl, tl, jq, tq = _prims(u, dim)
    dt, cfl = 2e-2, 0.5
    for d in range(dim):
        ref = jau.limit_hydro_fluxes_on_small_dens(jnp.asarray(flux), d, jnp.asarray(u), jq, jg,
                                                   jl, dt, cfl, 0.02, NG)
        got = au.limit_hydro_fluxes_on_small_dens(torch.as_tensor(flux), d, torch.as_tensor(u),
                                                  tq, tg, tl, dt, cfl, 0.02, NG)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
        changed = np.abs(got.numpy()[tl.URHO] - flux[tl.URHO]) > 1e-12
        assert 0.01 < changed.mean() < 0.99  # the limiter acted on some faces only
        ref = jau.limit_hydro_fluxes_on_large_vel(jnp.asarray(flux), d, jnp.asarray(u), jq, jg,
                                                  jl, dt, cfl, 4.0, NG)
        got = au.limit_hydro_fluxes_on_large_vel(torch.as_tensor(flux), d, torch.as_tensor(u),
                                                 tq, tg, tl, dt, cfl, 4.0, NG)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
        changed = np.abs(got.numpy()[tl.UMX] - flux[tl.UMX]) > 1e-12
        assert 0.01 < changed.mean() < 0.99


def test_clean_fill_with_speed_limit_matches_jax():
    u, _, _, _ = _state(2, seed=7)
    jl, tl = JLayout(dim=2, nspec=1), StateLayout(dim=2, nspec=1)
    ref = jclean.clean_state(jnp.asarray(u), jl, JEos(1.4, network=JNull()), small_dens=1e-12,
                             small_temp=1e-12, speed_limit=1.5)
    ref = j_fill_ghosts(ref, jl, (2, 3), (0, 0), NG)
    got = clean_and_fill(torch.as_tensor(u), tl, GammaLawEos(1.4, network=GeneralNullNetwork()),
                         (2, 3), (0, 0), NG, 1e-12, 1e-12, 1e-4, True, speed_limit=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)
    v = torch.sqrt(sum((got[m] / got[tl.URHO]) ** 2 for m in (1, 2, 3)))
    assert float(v.max()) <= 1.5 * (1 + 1e-12)


def _sedov(mod, dim, n, dtype, **castro):
    p = mod.make_params(n=n, dim=dim, stop_time=0.1, r_init=0.2, dtype=dtype)
    return p.with_ns("castro", **castro)


# name -> (dim, n, castro overrides, dtype, steps). small_dens 0.15 (3D) and
# 0.2 (2D) put the positivity limiter's floor (small_dens * 1.1 * 2 dim, 0.99
# and 0.88) just under the ambient density, so that it acts on the faces
# around the blast's rarefied centre (136 to 460 faces a direction in 3D)
CASES = {
    "small-dens-3d": (3, 8, dict(limit_fluxes_on_small_dens=1, small_dens=0.15), "float64", 2),
    "small-dens-2d": (2, 16, dict(limit_fluxes_on_small_dens=1, small_dens=0.2), "float32", 3),
    "speed-limit-3d": (3, 8, dict(speed_limit=1.0), "float64", 2),
    "speed-limit-2d": (2, 16, dict(speed_limit=1.0), "float64", 3),
    "transverse-eos-3d": (3, 8, dict(transverse_use_eos=1), "float64", 2),
    "transverse-eos-2d": (2, 16, dict(transverse_use_eos=1), "float64", 2),
}


def steps_match_jax(case):
    """The case's steps, the port against the JAX XLA path."""
    dim, n, castro, dtype, steps = CASES[case]
    dt = 4e-3
    states = jax_states(lambda: JSim(_sedov(jsedov, dim, n, dtype, **castro),
                                     problem_init=jsedov.problem_init), dtype, steps, dt)
    sim = Simulation(_sedov(sedov, dim, n, dtype, **castro), problem_init=sedov.problem_init,
                     device="cpu")
    port_matches(sim, states, dtype, dt)


@pytest.mark.parametrize("case", [k for k in CASES if k.endswith("3d")])
def test_steps_match_jax(case):
    """(The 2D cases are in tests/test_torch_limiters_2d.py.)"""
    steps_match_jax(case)


@pytest.mark.parametrize("castro,expected", [
    (dict(limit_fluxes_on_small_dens=1),
     {"prim_aux": 1, "flatten": 1, "trace_ppm": 3, "ctu_face": 6, "clean_fill": 1}),
    (dict(speed_limit=10.0),
     {"prim_aux": 1, "flatten": 1, "trace_ppm": 3, "ctu_face": 6}),
    (dict(transverse_use_eos=1), {}),
    (dict(ppm_type=0, limit_fluxes_on_small_dens=1),
     {"prim_aux": 1, "flatten": 1, "ctu_face": 9, "clean_fill": 1}),
], ids=["small-dens", "speed-limit", "transverse-eos", "plm-small-dens"])
def test_3d_kernel_structure(calls, castro, expected):
    """The wrappers a 3D step calls: with a limiter the finals fold no
    consup (6 ctu_face with the fused trace); speed_limit also takes the
    torch-op clean + fill; transverse_use_eos calls none."""
    sim = Simulation(_sedov(sedov, 3, 8, "float32", **castro),
                     problem_init=sedov.problem_init, device="cpu")
    assert step_calls(sim, calls) == expected
    assert sim.cfg.use_kernels == (not castro.get("transverse_use_eos"))
