"""Thermodynamic source (counterpart of `castro_tpu/sources/thermo_src.py`;
reference `Source/sources/Castro_thermo.cpp`, construct_old/new_thermo_source,
`Castro_sources.H:252-276`): the -p div(u) term of the internal energy as
an explicit source, for a time integration that carries (rho e) outside the
CTU pdivu machinery. `build_sources` does not list it, as the JAX package
does not (`castro_tpu/sources/__init__.py:57-60`): the MOL operators apply
pdivu through their Godunov states."""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import shifted


class ThermoSource:
    name = "thermo"

    def __init__(self, params, geom, layout, ng):
        self.geom = geom
        self.layout = layout
        self.ng = ng

    def __call__(self, sim, u, q, qaux, t, dt, ctx=None):
        L = self.layout
        div = torch.zeros_like(u[L.URHO])
        for d in range(L.dim):
            v = q[L.velocity_index(d)]
            div = div + (shifted(v, 1, d) - shifted(v, -1, d)) / (2 * self.geom.dx[d])
        src = torch.zeros_like(u)
        src[L.UEINT] = -q[L.QPRES] * div
        return src
