"""2D Riemann problems (counterpart of `castro_tpu/problems/riemann_2d.py`;
reference `Exec/hydro_tests/riemann_2d`): the four-quadrant Liska &
Wendroff (2003) configurations. The quadrant states (rho_k, ux_k, uy_k,
p_k) follow `problem_initialize_state_data.H:30-110`; the named
configurations are the reference's `inputs_c*` files."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

# quadrant numbering: 1 = upper-right, 2 = upper-left, 3 = lower-left,
# 4 = lower-right. Values: (rho, ux, uy, p) per quadrant.
CONFIGS = {
    # inputs_c3
    3: dict(q1=(1.5, 0.0, 0.0, 1.5), q2=(0.5323, 1.206, 0.0, 0.3),
            q3=(0.138, 1.206, 1.206, 0.029), q4=(0.5323, 0.0, 1.206, 0.3)),
    # inputs_c4 (Liska-Wendroff table 4.3 config 4)
    4: dict(q1=(1.1, 0.0, 0.0, 1.1), q2=(0.5065, 0.8939, 0.0, 0.35),
            q3=(1.1, 0.8939, 0.8939, 1.1), q4=(0.5065, 0.0, 0.8939, 0.35)),
    # inputs_c6 (slip-line configuration)
    6: dict(q1=(1.0, 0.75, -0.5, 1.0), q2=(2.0, 0.75, 0.5, 1.0),
            q3=(1.0, -0.75, 0.5, 1.0), q4=(3.0, -0.75, -0.5, 1.0)),
    # inputs_c12
    12: dict(q1=(0.5313, 0.0, 0.0, 0.4), q2=(1.0, 0.7276, 0.0, 1.0),
             q3=(0.8, 0.0, 0.0, 1.0), q4=(1.0, 0.0, 0.7276, 1.0)),
    # inputs_c15
    15: dict(q1=(1.0, 0.1, -0.3, 1.0), q2=(0.5197, -0.6259, -0.3, 0.4),
             q3=(0.8, 0.1, -0.3, 0.4), q4=(0.5313, 0.1, 0.4276, 0.4)),
    # inputs_c17
    17: dict(q1=(1.0, 0.0, -0.4, 1.0), q2=(2.0, 0.0, -0.3, 1.0),
             q3=(1.0625, 0.0, 0.2145, 0.4), q4=(0.5197, 0.0, -1.1259, 0.4)),
}


def make_params(n=128, config=3, stop_time=0.3, **prob):
    merged = dict(CONFIGS[config])
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n, n), stop_time=stop_time)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(1.0, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(2, 2, 0), hi_bc=(2, 2, 0), cfl=0.5, ppm_type=1,
                  small_dens=1e-10, small_temp=1e-10, small_pres=1e-12)
    p = p.with_ns("eos", eos_gamma=1.4)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def problem_init(sim, u):
    pp = dict(sim.params.problem)
    g = sim.geom
    shape = tuple(u.shape[1:])
    x = g.cell_centers(0, sim.ng).expand(shape)
    y = g.cell_centers(1, sim.ng).expand(shape)
    xc = 0.5 * (g.prob_lo[0] + g.prob_hi[0])
    yc = 0.5 * (g.prob_lo[1] + g.prob_hi[1])

    right = x >= xc
    upper = y >= yc
    quads = [(right & upper, pp["q1"]), (~right & upper, pp["q2"]),
             (~right & ~upper, pp["q3"]), (right & ~upper, pp["q4"])]
    rho, ux, uy, p = (torch.zeros(shape, dtype=u.dtype, device=u.device) for _ in range(4))
    for mask, (r, vx, vy, pk) in quads:
        rho = torch.where(mask, torch.full_like(rho, r), rho)
        ux = torch.where(mask, torch.full_like(ux, vx), ux)
        uy = torch.where(mask, torch.full_like(uy, vy), uy)
        p = torch.where(mask, torch.full_like(p, pk), p)
    return fill_from_prim(sim, u, rho, (ux, uy, 0.0), p=p)
