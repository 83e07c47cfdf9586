"""Radiation on two-level Cartesian AMR, the port's hierarchy against the
JAX package's (tests/test_amr_radiation.py's setup: a hot spot, gray FLD,
castro.do_hydro=0, and with hydro the characteristic rad-CTU step), float64:
the hierarchy is carried from the JAX package into the port
(`convert.hierarchy_to_numpy` / `restore_hierarchy`, u_rad included), then
both take 2 coarse steps: per-level Er and u_rad_old, the window's
coarse-Er Dirichlet faces at the substep midpoints, the ring fill, the
deferred-sync rhs and the Er average down. With hydro in
tests/test_torch_rad_amr_hydro.py, multigroup + Compton in
tests/test_torch_rad_amr_mg.py.

The JAX side runs its own jitted level steps. Compared on the masked
(valid) cells of each level; tolerance float64 1e-10 |jax| + 1e-10
max|jax| per component (the momenta sharing their scale)."""

import numpy as np
import torch

import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems.util import fill_from_prim as jfill

from castro_tpu_torch import convert
from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.problems.util import fill_from_prim as tfill

from test_torch_radiation import _few_threads, close, jit_jax_solve  # noqa: F401


def amr_params(P, n=16, ngroups=1, do_hydro=0):
    p = P().with_ns("amr", n_cell=(n, n), max_level=1, regrid_int=0,
                    refinement_indicators=("terr",))
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", do_radiation=1, do_hydro=do_hydro, lo_bc=(2, 2), hi_bc=(2, 2),
                  fixed_dt=2e-7, cfl=0.5)
    mg = dict(ngroups=4, lowest_group_hz=1.0e13, highest_group_hz=1.0e17,
              do_inelastic_scattering=1, const_kappa_r=5.0) if ngroups > 1 else {}
    p = p.with_ns("radiation", const_kappa_p=1e-6, const_kappa_r=50.0, limiter=0, ngroups=1)
    p = p.with_ns("radiation", **mg)
    p = p.replace(extra={"amr.terr.field": "Temp", "amr.terr.value_greater": 0.5})
    return p.with_ns("tpu", dtype="float64")


def _jinit(sim, u):
    r = sim.geom.radius(sim.ng, center=(0.5, 0.5))
    return jfill(sim, u, 1.0, (0.0, 0.0, 0.0), T=0.1 + jnp.exp(-(r / 0.12) ** 2))


def _tinit(sim, u):
    r = sim.geom.radius(sim.ng, center=(0.5, 0.5))
    return tfill(sim, u, 1.0, (0.0, 0.0, 0.0), T=0.1 + torch.exp(-(r / 0.12) ** 2))


def hierarchy_against_jax(ngroups=1, do_hydro=0, steps=2):
    ja = JAmr(amr_params(JParams, ngroups=ngroups, do_hydro=do_hydro), problem_init=_jinit)
    ja.init_data()
    ta = AmrSimulation(amr_params(Params, ngroups=ngroups, do_hydro=do_hydro),
                       problem_init=_tinit, device="cpu")
    ta.init_data()
    L = ta.sim0.layout
    vec = [(L.UMX, L.UMY, L.UMZ)]
    # the port's own initial hierarchy first, then the JAX package's carried in
    assert [tuple(w[1]) for w in ta.window[1:]] == [tuple(w[1]) for w in ja.window[1:]]
    for l in range(2):
        close(ta.u_rad[l], np.asarray(ja.u_rad[l]), what=f"init Er level {l}")
    convert.restore_hierarchy(ta, convert.hierarchy_to_numpy(ja))
    for k in range(steps):
        ja.advance(2e-7)
        ta.advance(2e-7)
        for l in range(2):
            m = np.asarray(ja.masks[l])
            u_j = np.asarray(ja.interior(l))[:, m]
            close(ta.interior(l)[:, torch.tensor(m)], u_j, what=f"u level {l} step {k + 1}",
                  vectors=vec)
            er_j, er_t = np.asarray(ja.u_rad[l]), ta.u_rad[l]
            if er_j.ndim == 2:
                er_j, er_t = er_j[None], er_t[None]
            close(er_t[:, torch.tensor(m)], er_j[:, m], what=f"Er level {l} step {k + 1}")
        assert sorted(ta._rad_sync_rhs) == sorted(ja._rad_sync_rhs) == [0]
        close(ta._rad_sync_rhs[0], np.asarray(ja._rad_sync_rhs[0]), what="sync rhs")
    return ja, ta


def test_amr_radiation_gray(jit_jax_solve):
    hierarchy_against_jax()
