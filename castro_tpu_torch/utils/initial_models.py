"""Initial-model generators: 1D hydrostatic structures built through the EOS
(counterpart of `castro_tpu/utils/initial_models.py`), for the problems
that read model files in the reference (`Util/initial_models`,
AMReX-Astro/initial_models: toy_atm for flame_wave/xrb/nova, spherical WD
models for sub_chandra/wdmerger, plane-parallel atmospheres for
reacting_bubble and the convecting tests).

A march is a scalar recurrence, each level's Newton solve waiting on the
one below, so it runs on the host, as the JAX package's numpy march does:
the EOS is evaluated on one-element float64 CPU tensors (`HostEos`), with
the JAX package's iteration counts and stopping tests, and only the
finished columns go to the device. The spherical march keeps the JAX
package's fixed 16 Newton iterations a shell and runs on tensors, on a
device of the caller's choice, for several central densities at once (the
white-dwarf mass bisection walks its tree that way, `wd_model_for_mass`);
its callbacks take and return tensors (`torch.where`, not a Python `if`,
on their argument).

Every generator returns a dict of numpy arrays keyed like a model file
(`density`, `temperature`, `pressure`, `spec_*`; `mass` for the spherical
ones)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.cuda_graph import GraphLoop


class HostEos:
    """Pointwise EOS evaluation on the host: (rho, T) as Python floats and a
    composition vector in."""

    def __init__(self, eos):
        self.eos = eos

    def state(self, rho, T, xn):
        """The EosState of one zone, one-element float64 CPU tensors (xn
        None: the EOS's composition-free state)."""
        t = lambda v: torch.tensor([float(v)], dtype=torch.float64)
        if xn is not None:
            xn = torch.as_tensor(np.asarray(xn, dtype=np.float64).reshape(-1, 1))
        return self.eos.rt(rho=t(rho), T=t(T), xn=xn)

    def p_dpdr_gam1(self, rho, T, xn):
        """(p, dp/drho|e, Gamma_1) as Python floats."""
        s = self.state(rho, T, xn)
        return float(s.p[0]), float(s.dpdr_e[0]), float(s.gam1[0])


def _newton_level(heos, rho_prev, p_prev, T, xn, g, dz):
    """rho with p(rho, T) = p_prev + 0.5 (rho_prev + rho) g dz: Newton from
    rho_prev, at most 20 iterations, halving a step that leaves rho > 0."""
    r = rho_prev
    for _ in range(20):
        pi, dpdr, _ = heos.p_dpdr_gam1(r, T, xn)
        f = pi - (p_prev + 0.5 * (rho_prev + r) * g * dz)
        df = dpdr - 0.5 * g * dz
        r_new = r - f / df
        if not np.isfinite(r_new) or r_new <= 0:
            r_new = 0.5 * r
        if abs(r_new - r) < 1e-12 * r:
            return r_new
        r = r_new
    return r


def _model(z, rho, T, p, xn):
    out = {"r": np.asarray(z, dtype=float), "density": rho, "temperature": T, "pressure": p}
    for k in range(xn.shape[0]):
        out[f"spec_{k}"] = xn[k]
    return out


def hse_plane_parallel(eos, z, rho_base, T_base, g, xn_of_z: Callable[[float], np.ndarray],
                       T_of_z: Optional[Callable[[float], float]] = None,
                       isentropic_until: Optional[float] = None,
                       T_min: float = 0.0) -> Dict[str, np.ndarray]:
    """March a plane-parallel HSE column upward: p_i = p_{i-1} + rho_avg g
    dz (g < 0 for gravity pointing down), Newton in rho at each level.

    Temperature: T_of_z, a prescribed profile; or, with isentropic_until,
    the adiabat dT = (Gamma_1 - 1)/Gamma_1 T/p dp up to that height and
    isothermal at max(T, T_min) above it; otherwise isothermal at T_base.
    """
    heos = HostEos(eos)
    n = len(z)
    dz = float(z[1] - z[0])
    rho, T, p = np.zeros(n), np.zeros(n), np.zeros(n)
    nspec = len(np.asarray(xn_of_z(float(z[0]))))
    xn = np.zeros((nspec, n))
    rho[0] = rho_base
    T[0] = T_base if T_of_z is None else T_of_z(float(z[0]))
    xn[:, 0] = xn_of_z(float(z[0]))
    p[0], _, _ = heos.p_dpdr_gam1(rho[0], T[0], xn[:, 0])
    for i in range(1, n):
        xn[:, i] = xn_of_z(float(z[i]))
        if T_of_z is not None:
            T[i] = T_of_z(float(z[i]))
        elif isentropic_until is not None and z[i] <= isentropic_until:
            _, _, gam1 = heos.p_dpdr_gam1(rho[i - 1], T[i - 1], xn[:, i - 1])
            dp_est = rho[i - 1] * g * dz
            nabla_ad = (gam1 - 1.0) / gam1
            T[i] = max(T[i - 1] * (1.0 + nabla_ad * dp_est / p[i - 1]), T_min)
        elif isentropic_until is not None:
            T[i] = max(T[i - 1], T_min)
        else:
            T[i] = max(T_base, T_min)
        rho[i] = max(_newton_level(heos, rho[i - 1], p[i - 1], T[i], xn[:, i], g, dz), 1e-30)
        p[i], _, _ = heos.p_dpdr_gam1(rho[i], T[i], xn[:, i])
    return _model(z, rho, T, p, xn)


def _spherical_lanes(eos, r, rho_c, T_c, xn_of_m: Callable, T_of_rho: Optional[Callable] = None,
                     rho_cutoff: float = 1e-4, device=None):
    """The spherical march of `hse_spherical` for several central densities
    at once (rho_c a sequence, one lane each), on `device` (default the
    CPU). The callbacks take one lane's 0-d tensor and are vmapped over the
    lanes. On the card one shell's body is captured once as a CUDA graph
    and replayed shell after shell (16 Newton iterations, a fixed count,
    and no host read: `utils/cuda_graph.py:GraphLoop`); elsewhere it runs
    eagerly. Returns the numpy columns
    rho, T, p, m [nshell, lanes] and `xn_at`, which gives a lane's
    composition column [nspec, nshell]: row i is xn_of_m of row i's mass
    (of 0 in row 0), as the march evaluated it, so it is not stored."""
    dev = torch.device("cpu" if device is None else device)
    f64 = dict(dtype=torch.float64, device=dev)
    r_arr = torch.as_tensor(np.asarray(r, dtype=np.float64), **f64)
    n = r_arr.shape[0]
    rho_c_ = torch.as_tensor(np.asarray(rho_c, dtype=np.float64).reshape(-1), **f64)
    xn_fn = torch.func.vmap(xn_of_m)
    T_fn = None if T_of_rho is None else torch.func.vmap(T_of_rho)
    cutoff = torch.tensor(float(rho_cutoff), **f64)

    def p_dpdr(rho, T, xn):
        s = eos.rt(rho=rho, T=T, xn=xn)
        return s.p, s.dpdr_e

    def xn_at(m):
        return xn_fn(m).T.contiguous()

    dr = r_arr[1] - r_arr[0]
    xn0 = xn_at(torch.zeros_like(rho_c_))
    T0 = torch.full_like(rho_c_, float(T_c)) if T_fn is None else T_fn(rho_c_)
    p0, _ = p_dpdr(rho_c_, T0, xn0)
    m0 = 4.0 / 3.0 * np.pi * r_arr[0] ** 3 * rho_c_
    # the march's state, updated in place shell after shell: the last shell,
    # the index of the next one and the columns
    k = torch.ones(1, dtype=torch.long, device=dev)
    state = [rho_c_.clone(), T0.clone(), p0.clone(), m0.clone(), xn0.clone(),
             torch.zeros_like(rho_c_, dtype=torch.bool), k]
    for v in state[:4]:
        col = torch.empty((n,) + tuple(v.shape), **f64)
        col[0] = v
        state.append(col)

    def shell(st):
        rho_p, T_p, p_p, m_p, xn_p, done, k = st[:7]
        r_i = torch.index_select(r_arr, 0, k)
        r_p = torch.index_select(r_arr, 0, k - 1)
        g_face = -C.Gconst * m_p / (0.5 * (r_i + r_p)) ** 2
        T_i = T_p if T_fn is None else T_fn(rho_p)
        rg = rho_p
        for _ in range(16):
            pi, dpdr = p_dpdr(rg, T_i, xn_p)
            f = pi - (p_p + 0.5 * (rho_p + rg) * g_face * dr)
            df = dpdr - 0.5 * g_face * dr
            rn = rg - f / df
            rg = torch.where(torch.isfinite(rn) & (rn > 0), rn, 0.5 * rg)
        done_i = done | (rg < rho_cutoff)
        rho_i = torch.where(done_i, cutoff, rg)
        if T_fn is not None:
            T_i = T_fn(rho_i)
        p_i, _ = p_dpdr(rho_i, T_i, xn_p)
        m_i = torch.where(done_i, m_p, m_p + 4.0 * np.pi * (0.5 * (r_i + r_p)) ** 2 * rho_i * dr)
        xn_i = xn_at(m_i)
        for i, v in enumerate((rho_i, T_i, p_i, m_i, xn_i, done_i)):
            st[i].copy_(v)
            if i < 4:
                st[7 + i].index_copy_(0, k, v[None])
        k.add_(1)

    _, state = GraphLoop(shell, keep=1)(state, n - 1)
    cols = state[7:]
    rho, T, p, m = (c.cpu().numpy() for c in cols)

    def lane_xn(j):
        mj = cols[3][:, j].clone()
        mj[0] = 0.0
        return xn_fn(mj).T.cpu().numpy()

    return rho, T, p, m, lane_xn


def _lane_model(r, cols, j):
    rho, T, p, m, lane_xn = cols
    out = _model(r, rho[:, j].copy(), T[:, j].copy(), p[:, j].copy(), lane_xn(j))
    out["mass"] = m[:, j].copy()
    return out


def hse_spherical(eos, r, rho_c, T_c, xn_of_m: Callable, T_of_rho: Optional[Callable] = None,
                  rho_cutoff: float = 1e-4, device=None) -> Dict[str, np.ndarray]:
    """Integrate a spherical hydrostatic star outward: dp/dr = -G m rho /
    r^2, dm/dr = 4 pi r^2 rho, 16 Newton iterations in rho a shell (the WD
    models behind sub_chandra and wdmerger). xn_of_m maps the enclosed mass
    (a 0-d tensor) to the composition (a tensor [nspec]); T_of_rho
    prescribes T(rho) (default: isothermal at T_c). Past rho < rho_cutoff
    the march freezes at the floor. `device`: where the march runs (default
    the CPU; the callbacks' tensors must be on it)."""
    cols = _spherical_lanes(eos, r, [float(rho_c)], T_c, xn_of_m, T_of_rho, rho_cutoff, device)
    return _lane_model(r, cols, 0)


def wd_mass(model: Dict[str, np.ndarray]) -> float:
    """Total mass (g) of a spherical model, above its floor tail."""
    rho = model["density"]
    live = rho > 1.5 * rho.min()
    return float(model["mass"][np.argwhere(live).max()]) if live.any() else 0.0


def wd_model_for_mass(eos, r, M_target, T_c, xn_of_m, rho_c_lo=1e5, rho_c_hi=5e9, iters=30,
                      levels=None, device=None, **kw) -> Dict[str, np.ndarray]:
    """Bisect the central density (in log) so that the spherical model
    holds M_target (wdmerger's initial-model iteration), through the
    sequence of midpoints of the sequential bisection: the 2^k - 1
    midpoints of the next k levels of the bisection tree march together,
    as lanes of one batched march, and the walk then follows the mass
    comparisons down the tree. k = `levels` (default 15 on the card, two
    marches of 32767 lanes for 30 steps; 5 elsewhere). The model returned also carries `marches`, the number of
    batched marches made."""
    dev = torch.device("cpu" if device is None else device)
    if levels is None:
        levels = 15 if dev.type == "cuda" else 5
    lo, hi = np.log(rho_c_lo), np.log(rho_c_hi)
    model = None
    left, marches = iters, 0
    while left > 0:
        k = min(levels, left)
        # heap order: node j's children are 2j+1 (mass too low: lo = mid)
        # and 2j+2 (hi = mid)
        nodes, mids = [(lo, hi)], []
        for j in range(2 ** k - 1):
            a, b = nodes[j]
            mid = 0.5 * (a + b)
            mids.append(mid)
            nodes += [(mid, b), (a, mid)]
        cols = _spherical_lanes(eos, r, [float(np.exp(mid)) for mid in mids], T_c, xn_of_m,
                                device=dev, **kw)
        marches += 1
        j = 0
        for _ in range(k):
            model = _lane_model(r, cols, j)
            if wd_mass(model) < M_target:
                lo, j = mids[j], 2 * j + 1
            else:
                hi, j = mids[j], 2 * j + 2
        left -= k
    model["marches"] = marches
    return model


def model_to_grid(model: Dict[str, np.ndarray], r_query) -> Dict[str, np.ndarray]:
    """Linear interpolation of every model variable onto query positions."""
    r = model["r"]
    return {k: np.interp(np.asarray(r_query), r, v) for k, v in model.items()
            if k != "r" and np.ndim(v) == 1}


def toy_atm(eos, z, dens_base, T_star, T_hi, T_lo, H_star, atm_delta, xn_star, xn_base,
            g) -> Dict[str, np.ndarray]:
    """The toy_atm atmosphere (reference
    `Exec/science/convective_flame/initial_model.H`; the shape of the
    toy_xrb / flame_wave / nova accreted layers): the substrate at T_star
    below H_star; a tanh transition (width atm_delta, centred 1.5 delta
    above H_star) of T to T_hi and of the composition xn_star to xn_base;
    above H_star + 3 delta the adiabat, floored at T_lo; HSE marched up
    from p(dens_base, T_star, xn_star)."""
    heos = HostEos(eos)
    n = len(z)
    dz = float(z[1] - z[0])
    xn_star = np.asarray(xn_star, dtype=float)
    xn_base = np.asarray(xn_base, dtype=float)
    z0 = float(z[0])
    rho, T, p = np.zeros(n), np.zeros(n), np.zeros(n)
    xn = np.zeros((len(xn_star), n))
    for i in range(n):
        xc = (z[i] - z0) - H_star - 1.5 * atm_delta
        f = 0.5 * (1.0 + np.tanh(xc / (0.5 * atm_delta)))
        xi = xn_star + (xn_base - xn_star) * f
        xn[:, i] = xi / xi.sum()
        T[i] = T_star if (z[i] - z0) <= H_star else T_star + (T_hi - T_star) * f
    rho[0] = dens_base
    p[0], _, _ = heos.p_dpdr_gam1(rho[0], T[0], xn[:, 0])
    isen_start = H_star + 3.0 * atm_delta
    for i in range(1, n):
        if (z[i] - z0) > isen_start:
            _, _, gam1 = heos.p_dpdr_gam1(rho[i - 1], T[i - 1], xn[:, i - 1])
            dp_est = rho[i - 1] * g * dz
            T[i] = max(T[i - 1] * (1.0 + (gam1 - 1.0) / gam1 * dp_est / p[i - 1]), T_lo)
        rho[i] = max(_newton_level(heos, rho[i - 1], p[i - 1], T[i], xn[:, i], g, dz), 1e-30)
        p[i], _, _ = heos.p_dpdr_gam1(rho[i], T[i], xn[:, i])
    return _model(z, rho, T, p, xn)


def isentrope_through(eos, rho0, T0, xn, p_min_fac=0.3, p_max_fac=4.0, npts=512):
    """Tabulate the isentrope through (rho0, T0): dT/drho|_s = (Gamma_3 -
    1) T / rho, Gamma_3 - 1 = dp/dT / (rho c_v), RK2 in log rho up and down
    until p leaves [p_min_fac, p_max_fac] p(rho0, T0). Returns dict(rho,
    T, p) sorted by p: the (p, s) inversion behind the reference's
    eos_input_ps initialization (reacting_convergence)."""
    heos = HostEos(eos)

    def g3m1(rho, T):
        s = heos.state(rho, T, xn)
        return float(s.dpdT[0]) / (rho * float(s.cv[0])), float(s.p[0])

    n_half = npts // 2
    out_r, out_T = [rho0], [T0]
    _, p0 = g3m1(rho0, T0)
    out_p = [p0]
    for direction in (+1, -1):
        rho, T = rho0, T0
        dlr = direction * 3.0 / n_half
        for _ in range(n_half):
            g1, _ = g3m1(rho, T)
            T_mid = T * np.exp(g1 * dlr * 0.5)
            rho_mid = rho * np.exp(dlr * 0.5)
            g2, _ = g3m1(rho_mid, T_mid)
            T = T * np.exp(g2 * dlr)
            rho = rho * np.exp(dlr)
            _, p = g3m1(rho, T)
            out_r.append(rho)
            out_T.append(T)
            out_p.append(p)
            if p > p_max_fac * p0 and direction > 0:
                break
            if p < p_min_fac * p0 and direction < 0:
                break
    order = np.argsort(out_p)
    return {"rho": np.asarray(out_r)[order], "T": np.asarray(out_T)[order],
            "p": np.asarray(out_p)[order]}
