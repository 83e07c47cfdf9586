"""HLLD approximate Riemann solver for ideal MHD (Miyoshi & Kusano 2005).

Counterpart of `castro_tpu/mhd/hlld.py` (reference `Source/mhd/hlld.cpp:9`,
the 5-wave solver of Castro's CT-CTU MHD), vectorized over whole face
arrays in torch ops; every branch is a `torch.where` over both sides, with
the same guards on the star-state divisions, so that a branch not taken
never feeds a NaN through a product.

State convention (rotated to the face): prim = (rho, un, ut1, ut2, p_gas,
Bn, Bt1, Bt2); the flux is returned in the same rotated frame: (rho, mn,
mt1, mt2, E, Bt1, Bt2); the flux of Bn is identically zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TINY = 1e-30


class MhdFaceState(NamedTuple):
    rho: torch.Tensor
    un: torch.Tensor
    ut1: torch.Tensor
    ut2: torch.Tensor
    p: torch.Tensor  # gas pressure
    Bt1: torch.Tensor
    Bt2: torch.Tensor
    e: torch.Tensor  # specific internal energy (for E)


def _cons(s: MhdFaceState, Bn, gamma):
    """Conserved vector (rotated): [rho, mn, mt1, mt2, E, Bt1, Bt2], and E."""
    ke = 0.5 * s.rho * (s.un ** 2 + s.ut1 ** 2 + s.ut2 ** 2)
    pb = 0.5 * (Bn ** 2 + s.Bt1 ** 2 + s.Bt2 ** 2)
    E = s.rho * s.e + ke + pb
    return torch.stack([s.rho, s.rho * s.un, s.rho * s.ut1, s.rho * s.ut2, E, s.Bt1, s.Bt2]), E


def _flux(s: MhdFaceState, Bn, E):
    pt = s.p + 0.5 * (Bn ** 2 + s.Bt1 ** 2 + s.Bt2 ** 2)
    vdotB = s.un * Bn + s.ut1 * s.Bt1 + s.ut2 * s.Bt2
    return torch.stack([
        s.rho * s.un,
        s.rho * s.un ** 2 + pt - Bn ** 2,
        s.rho * s.un * s.ut1 - Bn * s.Bt1,
        s.rho * s.un * s.ut2 - Bn * s.Bt2,
        (E + pt) * s.un - Bn * vdotB,
        s.Bt1 * s.un - Bn * s.ut1,
        s.Bt2 * s.un - Bn * s.ut2,
    ])


def fast_speed(rho, p, Bn, Bt1, Bt2, gamma):
    """The fast magnetosonic speed along the normal."""
    a2 = gamma * p / rho
    b2 = (Bn ** 2 + Bt1 ** 2 + Bt2 ** 2) / rho
    bn2 = Bn ** 2 / rho
    tmp = a2 + b2
    disc = torch.sqrt(torch.clamp(tmp * tmp - 4.0 * a2 * bn2, min=0.0))
    return torch.sqrt(0.5 * (tmp + disc))


def hlld(sl: MhdFaceState, sr: MhdFaceState, Bn, gamma):
    """HLLD flux. Returns (flux [7, ...], SM the contact speed)."""
    UL, EL = _cons(sl, Bn, gamma)
    UR, ER = _cons(sr, Bn, gamma)
    FL = _flux(sl, Bn, EL)
    FR = _flux(sr, Bn, ER)

    cfl = fast_speed(sl.rho, sl.p, Bn, sl.Bt1, sl.Bt2, gamma)
    cfr = fast_speed(sr.rho, sr.p, Bn, sr.Bt1, sr.Bt2, gamma)
    SL = torch.minimum(sl.un - cfl, sr.un - cfr)
    SR = torch.maximum(sl.un + cfl, sr.un + cfr)

    ptL = sl.p + 0.5 * (Bn ** 2 + sl.Bt1 ** 2 + sl.Bt2 ** 2)
    ptR = sr.p + 0.5 * (Bn ** 2 + sr.Bt1 ** 2 + sr.Bt2 ** 2)

    dL = sl.rho * (SL - sl.un)
    dR = sr.rho * (SR - sr.un)
    SM = (dR * sr.un - dL * sl.un - ptR + ptL) / (dR - dL)

    pts = ptL + dL * (SM - sl.un)

    def star(s, S, d, pt, E):
        rho_s = d / (S - SM)
        den = d * (S - SM) - Bn ** 2
        safe = torch.abs(den) > TINY * d * torch.clamp(S - SM, min=TINY)
        den_s = torch.where(safe, den, 1.0)
        fac_v = torch.where(safe, Bn * (SM - s.un) / den_s, 0.0)
        fac_B = torch.where(safe, (d * (S - s.un) - Bn ** 2) / den_s, 1.0)
        ut1_s = s.ut1 - s.Bt1 * fac_v
        ut2_s = s.ut2 - s.Bt2 * fac_v
        Bt1_s = s.Bt1 * fac_B
        Bt2_s = s.Bt2 * fac_B
        vB = s.un * Bn + s.ut1 * s.Bt1 + s.ut2 * s.Bt2
        vB_s = SM * Bn + ut1_s * Bt1_s + ut2_s * Bt2_s
        E_s = ((S - s.un) * E - pt * s.un + pts * SM + Bn * (vB - vB_s)) / (S - SM)
        return rho_s, ut1_s, ut2_s, Bt1_s, Bt2_s, E_s

    rhoLs, ut1Ls, ut2Ls, Bt1Ls, Bt2Ls, ELs = star(sl, SL, dL, ptL, EL)
    rhoRs, ut1Rs, ut2Rs, Bt1Rs, Bt2Rs, ERs = star(sr, SR, dR, ptR, ER)

    sqL = torch.sqrt(torch.clamp(rhoLs, min=TINY))
    sqR = torch.sqrt(torch.clamp(rhoRs, min=TINY))
    SLs = SM - torch.abs(Bn) / sqL
    SRs = SM + torch.abs(Bn) / sqR
    sgn = torch.sign(Bn)

    inv = 1.0 / (sqL + sqR)
    ut1_ss = (sqL * ut1Ls + sqR * ut1Rs + (Bt1Rs - Bt1Ls) * sgn) * inv
    ut2_ss = (sqL * ut2Ls + sqR * ut2Rs + (Bt2Rs - Bt2Ls) * sgn) * inv
    Bt1_ss = (sqL * Bt1Rs + sqR * Bt1Ls + sqL * sqR * (ut1Rs - ut1Ls) * sgn) * inv
    Bt2_ss = (sqL * Bt2Rs + sqR * Bt2Ls + sqL * sqR * (ut2Rs - ut2Ls) * sgn) * inv
    vB_ssL = SM * Bn + ut1Ls * Bt1Ls + ut2Ls * Bt2Ls
    vB_ssR = SM * Bn + ut1Rs * Bt1Rs + ut2Rs * Bt2Rs
    vB_ss = SM * Bn + ut1_ss * Bt1_ss + ut2_ss * Bt2_ss
    ELss = ELs - sqL * (vB_ssL - vB_ss) * sgn
    ERss = ERs + sqR * (vB_ssR - vB_ss) * sgn

    def U_star(rho_s, ut1_s, ut2_s, Bt1_s, Bt2_s, E_s):
        return torch.stack([rho_s, rho_s * SM, rho_s * ut1_s, rho_s * ut2_s, E_s, Bt1_s, Bt2_s])

    ULs = U_star(rhoLs, ut1Ls, ut2Ls, Bt1Ls, Bt2Ls, ELs)
    URs = U_star(rhoRs, ut1Rs, ut2Rs, Bt1Rs, Bt2Rs, ERs)
    ULss = U_star(rhoLs, ut1_ss, ut2_ss, Bt1_ss, Bt2_ss, ELss)
    URss = U_star(rhoRs, ut1_ss, ut2_ss, Bt1_ss, Bt2_ss, ERss)

    FLs = FL + SL[None] * (ULs - UL)
    FRs = FR + SR[None] * (URs - UR)
    FLss = FLs + SLs[None] * (ULss - ULs)
    FRss = FRs + SRs[None] * (URss - URs)

    F = torch.where((SL > 0.0)[None], FL,
        torch.where((SLs >= 0.0)[None], FLs,
        torch.where((SM >= 0.0)[None], FLss,
        torch.where((SRs >= 0.0)[None], FRss,
        torch.where((SR >= 0.0)[None], FRs, FR)))))
    return F, SM
