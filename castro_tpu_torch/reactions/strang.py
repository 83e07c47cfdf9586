"""Strang-split reaction coupling (counterpart of
`castro_tpu/reactions/strang.py`; reference `Castro::react_state`,
`Source/reactions/Castro_react.cpp:11-235`): half-dt burns before and
after the hydro update; T/rho gating (`react_T_min..react_rho_max`) and
the optional shock-burning switch; a burn changes X and e at constant rho,
updating UEINT/UEDEN/UFS, and returns omega_dot and the specific energy
release rate.

The NSE bypass of `network.nse=1` is not ported (ROADMAP.md, queue 1
item 7): it raises."""

from __future__ import annotations

from typing import Optional

import torch

from castro_tpu_torch.integrators.stiff import make_burner


class StrangReactor:
    def __init__(self, params, network, eos, layout):
        if params.network.nse:
            raise NotImplementedError(
                "not ported yet: network.nse=1, the NSE bypass of the burn (queue 1 item 7), "
                "see ROADMAP.md")
        self.params = params
        self.network = network
        self.eos = eos
        self.layout = layout
        ip = params.integrator
        self.burner = make_burner(network, eos, rtol=max(ip.rtol_spec, ip.rtol_enuc),
                                  atol_x=ip.atol_spec, atol_e=ip.atol_enuc)

    def react(self, u, dt, shk: Optional[torch.Tensor] = None):
        """Burn every (gated) zone for dt. Returns (u_new, omega_dot,
        enuc_rate, fail_any), fail_any a 0-d bool tensor."""
        L = self.layout
        c = self.params.castro
        rho = u[L.URHO]
        T = u[L.UTEMP]
        e = u[L.UEINT] / rho
        xn = u[L.UFS: L.UFS + L.nspec] / rho[None]

        # gate sentinels (react_T_max=1e200) exceed the float32 range; clamp
        # them to the working dtype's max (comparisons are unchanged)
        fmax = float(torch.finfo(u.dtype).max)
        ok = (T >= c.react_T_min) & (T <= min(c.react_T_max, fmax)) & \
             (rho >= c.react_rho_min) & (rho <= min(c.react_rho_max, fmax))
        if c.disable_shock_burning and shk is not None:
            ok = ok & (shk == 0.0)

        xn_new, e_new, fail = self.burner(rho, T, xn, e, dt)
        fail = fail & ok

        xn_out = torch.where(ok[None], xn_new, xn)
        e_out = torch.where(ok, e_new, e)

        omega_dot = (xn_out - xn) / dt
        enuc = (e_out - e) / dt  # erg/g/s

        u = u.clone()
        u[L.UFS: L.UFS + L.nspec] = rho[None] * xn_out
        de = rho * (e_out - e)
        u[L.UEINT] = u[L.UEINT] + de
        u[L.UEDEN] = u[L.UEDEN] + de
        return u, omega_dot, enuc, torch.any(fail)
