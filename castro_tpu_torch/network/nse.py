"""Nuclear statistical equilibrium composition solver (counterpart of
`castro_tpu/network/nse.py`, whose docstring sets out the physics; the
reference couples aprox19 and the NSE-enabled nets to a tabulated NSE
composition, Microphysics nse_tabular).

The Saha system is solved directly, every zone at once, in the proton and
neutron fugacities (a, b):

    Y_i = g_i A_i^{3/2} theta exp(Z_i a + N_i b + B_i / kT)
    theta = (m_u k T / 2 pi hbar^2)^{3/2} / (rho N_A)

subject to sum A_i Y_i = 1 and sum Z_i Y_i = Ye, every sum with a
log-sum-exp shift. Two branches, chosen by the network: when all species
share one Z/A (iso7, aprox13) the charge constraint is redundant and the
solve is a 1D Newton in a + b, `iters` steps; otherwise an 80-step (at
least `iters`) bisection on d = a - b with a 14-step inner Newton in
s = a + b. Every trip count is fixed, as in the JAX package: no host
synchronisation, so a whole solve can be captured as a CUDA graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import clip, vmax

_KB_MEV = C.k_B / C.MeV2erg  # MeV/K


def _species_table(network):
    """(A, Z, N, B [MeV], log(g A^{3/2})) as numpy arrays; the ground-state
    spins g default to 2 for A = 1 and 1 otherwise, He3 2 and N14 3."""
    A = np.asarray(network.aion, dtype=np.float64)
    Z = np.asarray(network.zion, dtype=np.float64)
    N = A - Z
    B = np.asarray(network.ebin) * A / (C.MeV2erg * C.N_A)
    g = getattr(network, "gspin", None)
    if g is None:
        g = np.where(A == 1, 2.0, 1.0)
        for name, gval in (("He3", 2.0), ("N14", 3.0)):
            if name in network.spec_names:
                g[network.spec_names.index(name)] = gval
    lg = np.log(np.asarray(g, dtype=float)) + 1.5 * np.log(A)
    return A, Z, N, B, lg


def make_nse_solver(network, iters=60):
    """nse(rho, T, ye) -> X [nspec, *shape] for same-shape tensors."""
    A, Z, N, B, lg = _species_table(network)
    degenerate = bool(np.allclose(Z / A, Z[0] / A[0]))
    cols = {}

    def columns(like):
        key = (like.device, like.dtype, like.dim())
        c = cols.get(key)
        if c is None:
            c = tuple(network.column(v, like, like.dim()) for v in (A, Z, N, B, lg, A * A))
            cols[key] = c
        return c

    def nse(rho, T, ye):
        A_c, Z_c, N_c, B_c, lg_c, AA_c = columns(rho)
        kT = _KB_MEV * T
        nq = (C.m_u * C.k_B * T / (2.0 * np.pi * (C.hplanck / (2.0 * np.pi)) ** 2)) ** 1.5
        ltheta = torch.log(nq / (rho * C.N_A))
        log2 = math.log(2.0)

        def logY(a, b):
            return lg_c + ltheta[None] + Z_c * a[None] + N_c * b[None] + B_c / kT[None]

        def mass_newton(t):
            """(G1, the raw Newton step's denominator) of the mass
            constraint G1 = log sum A Y at the log-abundances t."""
            m = torch.max(t, dim=0).values
            et = torch.exp(t - m[None])
            SA = vmax(torch.sum(A_c * et, dim=0), 1e-300)
            SAA = torch.sum(AA_c * et, dim=0)
            return m + torch.log(SA), 0.5 * SAA / SA

        # initial guess: free nucleons only (Y_p = ye, Y_n = 1 - ye)
        a = torch.log(vmax(ye, 1e-10)) - ltheta - log2
        b = torch.log(vmax(1.0 - ye, 1e-10)) - ltheta - log2

        if degenerate:
            # G1(s) is convex increasing in s (log-sum-exp of affine
            # terms): the raw Newton step converges globally
            for _ in range(iters):
                G1, den = mass_newton(logY(a, b))
                ds = -G1 / den
                a, b = a + 0.5 * ds, b + 0.5 * ds
        else:
            # the charge fraction at fixed mass is monotone in d = a - b:
            # bisect on d, with a warm-started Newton in s = a + b inside
            def solve_mass(d, s):
                for _ in range(14):
                    G1, den = mass_newton(logY(0.5 * (s + d), 0.5 * (s - d)))
                    s = s - G1 / den
                return s

            def ye_of(d, s):
                t = logY(0.5 * (s + d), 0.5 * (s - d))
                m = torch.max(t, dim=0).values
                et = torch.exp(t - m[None])
                SA = vmax(torch.sum(A_c * et, dim=0), 1e-300)
                SZ = torch.sum(Z_c * et, dim=0)
                return SZ / SA

            d0 = a - b
            s = a + b
            lo = d0 - 600.0
            hi = d0 + 600.0
            for _ in range(max(iters, 80)):
                mid = 0.5 * (lo + hi)
                s = solve_mass(mid, s)
                too_low = ye_of(mid, s) < ye
                lo = torch.where(too_low, mid, lo)
                hi = torch.where(too_low, hi, mid)
            d = 0.5 * (lo + hi)
            s = solve_mass(d, s)
            a = 0.5 * (s + d)
            b = 0.5 * (s - d)
        Yi = torch.exp(clip(logY(a, b), -300.0, 300.0))
        X = A_c * Yi
        # exact renormalisation against round-off in sum A Y = 1
        return X / vmax(torch.sum(X, dim=0), 1e-300)

    return nse


def nse_ebind(network, X):
    """Specific nuclear binding energy (erg/g) of the composition X."""
    return torch.sum(network.column(network.ebin, X, X.dim() - 1) * X, dim=0)
