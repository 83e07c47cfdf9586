"""Strang-split reaction coupling (counterpart of
`castro_tpu/reactions/strang.py`; reference `Castro::react_state`,
`Source/reactions/Castro_react.cpp:11-235`): half-dt burns before and
after the hydro update; T/rho gating (`react_T_min..react_rho_max`) and
the optional shock-burning switch; a burn changes X and e at constant rho,
updating UEINT/UEDEN/UFS, and returns omega_dot and the specific energy
release rate.

With `network.nse=1`, zones past the rho/T thresholds take the NSE
composition instead of the burn's result (reference nse_tabular coupling):
every zone is burned and every zone's equilibrium is solved, and
`torch.where` picks, as in the JAX package. On the card the bisection for
the NSE temperature replays one captured CUDA graph a bisection."""

from __future__ import annotations

from typing import Optional

import torch

from castro_tpu_torch.integrators.stiff import make_burner
from castro_tpu_torch.utils.cuda_graph import GraphLoop
from castro_tpu_torch.utils.tmath import clip, vmax


class StrangReactor:
    def __init__(self, params, network, eos, layout):
        self.params = params
        self.network = network
        self.eos = eos
        self.layout = layout
        ip = params.integrator
        self.burner = make_burner(network, eos, rtol=max(ip.rtol_spec, ip.rtol_enuc),
                                  atol_x=ip.atol_spec, atol_e=ip.atol_enuc)
        self.nse = None
        if params.network.nse:
            from castro_tpu_torch.network.nse import make_nse_solver

            self.nse = make_nse_solver(network)
            self._bisect_loop = GraphLoop(self._bisect_step)

    def _apply_nse(self, rho, T, xn, e, xn_new, e_new):
        """Replace the burn's result with the NSE composition in the zones
        past the thresholds. The temperature T* balances the thermal energy
        at the equilibrium composition against the binding energy released
        in reaching it, F(T) = e_eos(rho, T, X_nse(T)) - [e + sum ebin
        (X_nse(T) - xn)], found by 40 bisections in log T (F is monotone
        in T). Returns (xn_out, e_out, in_nse)."""
        np_ = self.params.network
        net = self.network
        nd = rho.dim()
        ye = clip(torch.sum(net.column(net.zion / net.aion, xn, nd) * xn, dim=0), 1e-3, 1.0)
        in_nse = ((T >= np_.T_nse) & (rho >= np_.rho_nse)) | (T >= np_.T_always_nse)
        T_lo, T_hi = self._bisect(rho, ye, xn, e)
        X_nse = self.nse(rho, torch.sqrt(T_lo * T_hi), ye)
        e_nse = vmax(self._avail(X_nse, xn, e), 1e-10)
        return (torch.where(in_nse[None], X_nse, xn_new), torch.where(in_nse, e_nse, e_new),
                in_nse)

    def _avail(self, X_T, xn, e):
        """e + sum ebin (X_T - xn): the energy left after the binding energy
        released in relaxing xn to X_T."""
        return e + torch.sum(self.network.column(self.network.ebin, xn, xn.dim() - 1)
                             * (X_T - xn), dim=0)

    def _bisect_step(self, st):
        """One bisection of T* in log T, in place on st = [rho, ye, xn, e,
        T_lo, T_hi]."""
        rho, ye, xn, e, T_lo, T_hi = st
        T_m = torch.sqrt(T_lo * T_hi)
        X_T = self.nse(rho, T_m, ye)
        too_hot = (self.eos.rt(rho=rho, T=T_m, xn=X_T).e - self._avail(X_T, xn, e)) > 0.0
        T_lo.copy_(torch.where(too_hot, T_lo, T_m))
        T_hi.copy_(torch.where(too_hot, T_m, T_hi))

    def _bisect(self, rho, ye, xn, e, n=40, graph=True):
        """n bisections from [1e7, 5e10] K; returns (T_lo, T_hi). On the card
        one bisection (an NSE solve, some 2e4 launches, and a Helmholtz
        evaluation) is captured as a CUDA graph and replayed, the same
        operations on the same values as the eager loop (graph=False)."""
        st = [rho, ye, xn, e, torch.full_like(rho, 1.0e7), torch.full_like(rho, 5.0e10)]
        _, st = self._bisect_loop(st, n, graph=graph)
        return st[4].clone(), st[5].clone()

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
        if self.nse is not None:
            xn_new, e_new, in_nse = self._apply_nse(rho, T, xn, e, xn_new, e_new)
            fail = fail & ~in_nse  # NSE zones bypass the integrator

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
