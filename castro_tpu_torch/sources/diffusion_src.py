"""Explicit thermal diffusion source div(k grad T) (counterpart of
`castro_tpu/sources/diffusion_src.py`; reference `Source/diffusion/`:
construct_old/new_diff_source, Castro_diffusion.cpp; the conductivity fill
of diffusion_util.cpp; the operator is AMReX's MLABecLaplacian applyop,
here a direct face-flux stencil).

Conductivity: constant, or the power law k = k0 T^nu (Microphysics
conductivity/{constant,powerlaw}), from `conductivity.const_conductivity`
and `conductivity.cond_exponent` in the inputs. The stencil runs on the
grown grid through `shifted`: only the interior is valid."""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import shifted


class DiffusionSource:
    name = "diff"

    def __init__(self, params, geom, layout, ng):
        self.geom = geom
        self.layout = layout
        self.ng = ng
        self.c = params.castro
        # inputs values arrive parsed (config._parse_token); a string here
        # is a typo in the inputs and raises
        self.k0 = float(params.extra.get("conductivity.const_conductivity", 1.0))
        self.nu = float(params.extra.get("conductivity.cond_exponent", 0.0))

    def conductivity(self, rho, T):
        if self.nu == 0.0:
            return torch.full_like(T, self.k0)
        return self.k0 * T ** self.nu

    def __call__(self, sim, u, q, qaux, t, dt, ctx=None):
        L = self.layout
        T = u[L.UTEMP]
        rho = u[L.URHO]
        k = self.conductivity(rho, T)
        cutoff = self.c.diffuse_cutoff_density
        if cutoff > -1e19:
            k = torch.where(rho < cutoff, torch.zeros_like(k), k)

        div = torch.zeros_like(T)
        for d in range(L.dim):
            dxd = self.geom.dx[d]
            k_lo = 0.5 * (k + shifted(k, -1, d))  # face i-1/2
            flux_lo = k_lo * (T - shifted(T, -1, d)) / dxd
            flux_hi = shifted(flux_lo, 1, d)
            div = div + (flux_hi - flux_lo) / dxd

        src = torch.zeros_like(u)
        src[L.UEINT] = div
        src[L.UEDEN] = div
        return src
