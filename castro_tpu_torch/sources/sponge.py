"""The sponge (counterpart of `castro_tpu/sources/sponge.py`; reference
`Source/sources/Castro_sponge.cpp`): velocity damping in radius, density
and pressure bands, a smooth ramp between the lower and upper bounds,
timescale tau, optional target velocities, implicit by default."""

from __future__ import annotations

import math

import torch


def _ramp(x, lo, hi):
    """0 below lo, 1 above hi, a smooth cosine between (the reference
    sponge factor)."""
    t = torch.clamp((x - lo) / max(hi - lo, 1e-300), 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * t))


class SpongeSource:
    name = "sponge"

    def __init__(self, params, geom, layout, ng):
        self.p = params.castro
        self.geom = geom
        self.layout = layout
        self.ng = ng

    def __call__(self, sim, u, q, qaux, t, dt, ctx=None):
        L = self.layout
        c = self.p
        geom = ctx.geom if ctx is not None else self.geom
        fac = torch.zeros_like(u[L.URHO])
        if c.sponge_upper_radius > 0.0:
            r = geom.radius(self.ng).expand(fac.shape)
            fac = torch.maximum(fac, _ramp(r, c.sponge_lower_radius, c.sponge_upper_radius))
        if c.sponge_lower_density > 0.0:
            # the density sponge: full strength below lower_density
            fac = torch.maximum(fac, 1.0 - _ramp(u[L.URHO], c.sponge_upper_density,
                                                 c.sponge_lower_density))
        if c.sponge_lower_pressure > 0.0:
            fac = torch.maximum(fac, 1.0 - _ramp(q[L.QPRES], c.sponge_upper_pressure,
                                                 c.sponge_lower_pressure))
        tau = c.sponge_timescale if c.sponge_timescale > 0.0 else dt
        rho = u[L.URHO]
        target = (c.sponge_target_x_velocity, c.sponge_target_y_velocity,
                  c.sponge_target_z_velocity)
        src = torch.zeros_like(u)
        e_src = 0.0
        for d, comp in enumerate((L.UMX, L.UMY, L.UMZ)):
            mom = u[comp]
            f = -fac / tau * (mom - rho * target[d])
            if c.sponge_implicit:
                # implicit damping: the equivalent source of the update
                f = f / (1.0 + fac * dt / tau)
            src[comp] = f
            e_src = e_src + (mom / rho) * f
        src[L.UEDEN] = e_src
        return src
