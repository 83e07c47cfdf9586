"""Sod_stellar: shock tubes through the Helmholtz stellar EOS (counterpart
of `castro_tpu/problems/sod_stellar.py`; reference
`Exec/hydro_tests/Sod_stellar`, the Zingale & Katz 2015 test suite). The
states are set from (rho, T) pairs through the EOS (`use_Tinit=1`), as in
`inputs-test1-helm` / `problem_initialize_state_data.H`.

Tests (reference inputs):
  test1: rho 1e7 / 1e6, T 1e8 / 1e6   (strong stellar shock tube)
  test2: rho 1e8 / 1e8, T 5e8 / 1e8   (double rarefaction-like)
  test3: rho 5e6 / 5e6, T 1e9 / 1e8   (strong T jump)
"""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

TESTS = {
    1: dict(rho_l=1.0e7, T_l=1.0e8, u_l=0.0, rho_r=1.0e6, T_r=1.0e6, u_r=0.0, stop_time=8.0e-4),
    2: dict(rho_l=1.0e8, T_l=5.0e8, u_l=-2.0e8, rho_r=1.0e8, T_r=5.0e8, u_r=2.0e8,
            stop_time=1.0e-4),
    3: dict(rho_l=5.0e6, T_l=1.0e9, u_l=0.0, rho_r=5.0e6, T_r=1.0e8, u_r=0.0, stop_time=5.0e-5),
}


def make_params(test=1, n=128, **prob):
    merged = dict(TESTS[test], frac=0.5)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), stop_time=merged["stop_time"])
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(1.0e6, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(2,), hi_bc=(2,), cfl=0.8, riemann_solver=1, use_flattening=1,
                  ppm_type=1, init_shrink=0.1, change_max=1.1, small_dens=1e-5, small_temp=1e4)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", nspec=1, spec_names=("He4",))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def problem_init(sim, u):
    pp = sim.params.problem
    g = sim.geom
    shape = tuple(u.shape[1:])
    x = g.cell_centers(0, sim.ng).expand(shape)
    xint = g.prob_lo[0] + pp["frac"] * (g.prob_hi[0] - g.prob_lo[0])
    left = x < xint

    def side(k):
        return torch.where(left, torch.full_like(x, pp[f"{k}_l"]), torch.full_like(x, pp[f"{k}_r"]))

    return fill_from_prim(sim, u, side("rho"), (side("u"), 0.0, 0.0), T=side("T"))
