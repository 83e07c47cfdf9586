"""The source-term framework (counterpart of `castro_tpu/sources/__init__.py`).

Reference: the ordered source list thermo/diff/hybrid/grav/rot/sponge/ext/
geom (`Source/driver/Castro.H:100-118`), old-time sources from S^n and the
time-centred corrector (`Source/sources/Castro_sources.cpp:123,185`).

A source is a callable (sim, u, q, qaux, t, dt, ctx=None) -> src [NVAR,
grown grid]. The step applies dt*S_old with the hydro update (and traces
it into the interface states through src_to_prim), then the corrector
0.5*dt*(S_new - S_old); a source with a `corrector(sim, u_old, u_new, t,
dt, ctx, fluxes)` (gravity) supplies its own dt*corr instead. Gravity, the
sponge, the hybrid-momentum source (hybrid_hydro) and the 2D RZ geometric
source are ported; diffusion, rotation and external sources raise, naming
their ROADMAP.md item.
"""

from __future__ import annotations

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops.hybrid import HybridSource
from castro_tpu_torch.sources.geom_src import GeomSource
from castro_tpu_torch.sources.gravity_src import GravitySource
from castro_tpu_torch.sources.sponge import SpongeSource


def build_sources(params, geom, layout, ng):
    """The active sources of `params`, in the reference's order."""
    c = params.castro
    unported = [
        (bool(c.do_thermal_diffusion or c.diffuse_temp), "thermal diffusion", 10),
        (bool(c.do_rotation), "rotation", 10),
        (bool(c.add_ext_src), "external sources", 10),
    ]
    for on, name, item in unported:
        if on:
            raise NotImplementedError(
                f"not ported yet: {name} (queue 1 item {item}), see ROADMAP.md")
    srcs = []
    if c.do_grav:
        from castro_tpu_torch.gravity import Gravity

        srcs.append(GravitySource(Gravity(params, geom, layout, ng)))
    if c.do_sponge:
        srcs.append(SpongeSource(params, geom, layout, ng))
    if c.hybrid_hydro and layout.hybrid_momentum:
        srcs.append(HybridSource(geom, layout, ng))
    if geom.coord == CoordSys.CYLINDRICAL and geom.dim == 2:
        srcs.append(GeomSource(params, geom, layout, ng))
    return srcs
