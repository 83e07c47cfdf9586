"""The 3D burning blob: a Gaussian of hot, dense helium in a cold, thin
background, burning through iso7 with Strang splitting while it expands
into outflow boundaries.

The JAX package defines this setup in `__graft_entry__.py:79-109`
(`_fullphys_sim`, its full-physics configuration: CTU hydro, Poisson
gravity with multipole BCs, iso7 Strang reactions, sponge): rho = 1e6
exp(-(r/5e7)^2) + 1e-3 g/cm^3, T = 2e8 exp(-(r/5e7)^2) + 1e7 K, pure He4,
on [-1e8, 1e8]^3 cm, small_dens 1e-5, small_temp 1e5. `physics="full"`
is that configuration whole: do_grav=1 (PoissonGrav,
max_multipole_order=2) and do_sponge=1 (sponge densities 1e-4 / 1e-3).
The default, `physics="burn"`, keeps the physics set but gravity and the
sponge. `eos` chooses the gamma law (the JAX configuration's) or
Helmholtz.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim


def make_params(n=128, dtype="float32", eos="gamma_law", physics="burn"):
    if physics not in ("burn", "full"):
        raise ValueError(f"physics={physics!r}: 'burn' or 'full'")
    full = int(physics == "full")
    p = Params()
    p = p.with_ns("amr", n_cell=(n, n, n))
    p = p.with_ns("geometry", prob_lo=(-1e8,) * 3, prob_hi=(1e8,) * 3)
    p = p.with_ns("castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), do_grav=full, do_react=1,
                  do_sponge=full, small_dens=1e-5, small_temp=1e5)
    if full:
        p = p.with_ns("castro", sponge_lower_density=1e-4, sponge_upper_density=1e-3)
        p = p.with_ns("gravity", gravity_type="PoissonGrav", max_multipole_order=2)
    p = p.with_ns("network", network_name="iso7")
    p = p.with_ns("eos", eos_name=eos)
    return p.with_ns("tpu", dtype=dtype)


def problem_init(sim, u):
    r = sim.geom.radius(sim.ng, center=(0.0,) * 3)
    g = torch.exp(-(r / 5e7) ** 2)
    rho = 1e6 * g + 1e-3
    T = 2e8 * g + 1e7
    # xn=None: the first species (He4) is 1
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T)
