"""The source-term framework (counterpart of `castro_tpu/sources/__init__.py`).

Reference: the ordered source list thermo/diff/hybrid/grav/rot/sponge/ext/
geom (`Source/driver/Castro.H:100-118`), old-time sources from S^n and the
time-centred corrector (`Source/sources/Castro_sources.cpp:123,185`).

A source is a callable (sim, u, q, qaux, t, dt, ctx=None) -> src [NVAR,
grown grid]. The step applies dt*S_old with the hydro update (and traces
it into the interface states through src_to_prim), then the corrector
0.5*dt*(S_new - S_old); a source with a `corrector(sim, u_old, u_new, t,
dt, ctx, fluxes)` (gravity, rotation) supplies its own dt*corr instead,
and the corrections of several such sources add. Thermal diffusion,
gravity, rotation, the sponge, the hybrid-momentum source (hybrid_hydro),
a problem's external source and the 2D RZ geometric source are ported.
The thermodynamic source (`sources/thermo_src.py`) stays out of the list,
as the JAX package keeps it out (`castro_tpu/sources/__init__.py:57-60`).
"""

from __future__ import annotations

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops.hybrid import HybridSource
from castro_tpu_torch.sources.diffusion_src import DiffusionSource
from castro_tpu_torch.sources.geom_src import GeomSource
from castro_tpu_torch.sources.gravity_src import GravitySource
from castro_tpu_torch.sources.rotation_src import RotationSource
from castro_tpu_torch.sources.sponge import SpongeSource


def build_sources(params, geom, layout, ng, ext_src=None):
    """The active sources of `params`, in the reference's order: diff, grav,
    rot, sponge, hybrid, ext, geom. `ext_src` is the problem's external
    source (castro.add_ext_src=1), a callable with a source's signature
    (sim, u, q, qaux, t, dt, ctx=None); without one add_ext_src adds
    nothing, as in the JAX package."""
    c = params.castro
    srcs = []
    if c.do_thermal_diffusion or c.diffuse_temp:
        srcs.append(DiffusionSource(params, geom, layout, ng))
    if c.do_grav:
        from castro_tpu_torch.gravity import Gravity

        srcs.append(GravitySource(Gravity(params, geom, layout, ng)))
    if c.do_rotation:
        srcs.append(RotationSource(params, geom, layout, ng))
    if c.do_sponge:
        srcs.append(SpongeSource(params, geom, layout, ng))
    if c.hybrid_hydro and layout.hybrid_momentum:
        srcs.append(HybridSource(geom, layout, ng))
    if c.add_ext_src and ext_src is not None:
        srcs.append(ext_src)
    if geom.coord == CoordSys.CYLINDRICAL and geom.dim == 2:
        srcs.append(GeomSource(params, geom, layout, ng))
    return srcs
