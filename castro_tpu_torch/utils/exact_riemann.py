"""Exact Riemann solver for gamma-law gases (Toro ch. 4).

Verification oracle: the reference ships the same capability as the
`Util/exact_riemann` Fortran executable (`Docs/source/Verification.rst`).
numpy only. It holds the Sod runs of the tests and of `chip_smoke.py`
against the exact solution."""

from __future__ import annotations

import numpy as np


def _f_side(p, rho_k, p_k, c_k, g):
    if p > p_k:  # shock
        A = 2.0 / ((g + 1.0) * rho_k)
        B = (g - 1.0) / (g + 1.0) * p_k
        f = (p - p_k) * np.sqrt(A / (p + B))
        df = np.sqrt(A / (B + p)) * (1.0 - (p - p_k) / (2.0 * (B + p)))
    else:  # rarefaction
        f = 2.0 * c_k / (g - 1.0) * ((p / p_k) ** ((g - 1.0) / (2.0 * g)) - 1.0)
        df = 1.0 / (rho_k * c_k) * (p / p_k) ** (-(g + 1.0) / (2.0 * g))
    return f, df


def star_state(rho_l, u_l, p_l, rho_r, u_r, p_r, gamma):
    c_l = np.sqrt(gamma * p_l / rho_l)
    c_r = np.sqrt(gamma * p_r / rho_r)
    p = max(1e-8, 0.5 * (p_l + p_r))
    for _ in range(60):
        f_l, df_l = _f_side(p, rho_l, p_l, c_l, gamma)
        f_r, df_r = _f_side(p, rho_r, p_r, c_r, gamma)
        f = f_l + f_r + (u_r - u_l)
        p_new = max(1e-10, p - f / (df_l + df_r))
        if abs(p_new - p) < 1e-14 * p:
            p = p_new
            break
        p = p_new
    f_l, _ = _f_side(p, rho_l, p_l, c_l, gamma)
    f_r, _ = _f_side(p, rho_r, p_r, c_r, gamma)
    u = 0.5 * (u_l + u_r) + 0.5 * (f_r - f_l)
    return p, u


def sample(xi, rho_l, u_l, p_l, rho_r, u_r, p_r, gamma):
    """Solution state at similarity coordinate xi = x/t."""
    g = gamma
    c_l = np.sqrt(g * p_l / rho_l)
    c_r = np.sqrt(g * p_r / rho_r)
    p_s, u_s = star_state(rho_l, u_l, p_l, rho_r, u_r, p_r, g)

    if xi < u_s:  # left of contact
        if p_s > p_l:  # left shock
            rho_sl = rho_l * ((p_s / p_l + (g - 1) / (g + 1)) /
                              ((g - 1) / (g + 1) * p_s / p_l + 1))
            S_l = u_l - c_l * np.sqrt((g + 1) / (2 * g) * p_s / p_l + (g - 1) / (2 * g))
            return (rho_l, u_l, p_l) if xi < S_l else (rho_sl, u_s, p_s)
        else:  # left rarefaction
            rho_sl = rho_l * (p_s / p_l) ** (1 / g)
            c_sl = c_l * (p_s / p_l) ** ((g - 1) / (2 * g))
            if xi < u_l - c_l:
                return rho_l, u_l, p_l
            if xi > u_s - c_sl:
                return rho_sl, u_s, p_s
            u = 2 / (g + 1) * (c_l + (g - 1) / 2 * u_l + xi)
            c = 2 / (g + 1) * (c_l + (g - 1) / 2 * (u_l - xi))
            rho = rho_l * (c / c_l) ** (2 / (g - 1))
            p = p_l * (c / c_l) ** (2 * g / (g - 1))
            return rho, u, p
    else:  # right of contact
        if p_s > p_r:  # right shock
            rho_sr = rho_r * ((p_s / p_r + (g - 1) / (g + 1)) /
                              ((g - 1) / (g + 1) * p_s / p_r + 1))
            S_r = u_r + c_r * np.sqrt((g + 1) / (2 * g) * p_s / p_r + (g - 1) / (2 * g))
            return (rho_r, u_r, p_r) if xi > S_r else (rho_sr, u_s, p_s)
        else:  # right rarefaction
            rho_sr = rho_r * (p_s / p_r) ** (1 / g)
            c_sr = c_r * (p_s / p_r) ** ((g - 1) / (2 * g))
            if xi > u_r + c_r:
                return rho_r, u_r, p_r
            if xi < u_s + c_sr:
                return rho_sr, u_s, p_s
            u = 2 / (g + 1) * (-c_r + (g - 1) / 2 * u_r + xi)
            c = 2 / (g + 1) * (c_r - (g - 1) / 2 * (u_r - xi))
            rho = rho_r * (c / c_r) ** (2 / (g - 1))
            p = p_r * (c / c_r) ** (2 * g / (g - 1))
            return rho, u, p


def solution(x, t, x0, rho_l, u_l, p_l, rho_r, u_r, p_r, gamma):
    """Vectorized over x: exact (rho, u, p) at time t."""
    out = np.array([sample((xi - x0) / t, rho_l, u_l, p_l, rho_r, u_r, p_r, gamma)
                    for xi in np.asarray(x)])
    return out[:, 0], out[:, 1], out[:, 2]
