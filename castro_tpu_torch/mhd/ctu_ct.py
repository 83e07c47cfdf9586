"""Corner-transport-upwind constrained-transport (CTU-CT) ideal MHD.

Counterpart of `castro_tpu/mhd/ctu_ct.py` (reference: Miniati & Martin;
`Source/mhd/Castro_mhd.cpp:construct_ctu_mhd_source`, `ct_upwind.cpp`,
`electric.cpp`, `mhd_plm.cpp`, `mhd_ppm.cpp`, `mhd_eigen.H`) in whole-array
torch ops, as the JAX package leaves it to XLA:

  ctoprim(+B) -> flatten (p and ptot) -> characteristic PLM or PPM tracing
  with the MHD source terms (Miniati Eq. 32-33) -> 1D HLLD fluxes (MM step
  1) -> edge EMFs with upwinded cell-E derivatives (Gardiner-Stone, MM Eq.
  36/41-43) -> 6 corner-coupled states + HLLD (MM Eq. 37-40) -> half-step
  states with the double transverse flux + EMF corrections (MM Eq. 44-46)
  -> 3 final HLLD fluxes (Eq. 47) -> half-time primitives (Eq. 48) ->
  final EMFs -> conservative update + face-B curl (div B = 0 to round-off).

State: extended primitives qx [NQ+3, grid] with QMG{0,1,2} = NQ+{0,1,2}
(cell-centred B) and extended conserved ux [NVAR+3] with UMG{d} = NVAR+d;
face-B fields b[d] use the face i-1/2 at index i convention.
"""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.mhd.hlld import MhdFaceState, fast_speed, hlld
from castro_tpu_torch.ops.stencil import shifted

# eigen-space component ordering (mhd_sizes.H)
IRHO, IU, IV, IW, IP, IBT, IBTT = range(7)
NEIGN = 7


def _taxes(d):
    t = [a for a in range(3) if a != d]
    return t[0], t[1]


def _eps(i, j, k):
    if i == j or j == k or i == k:
        return 0
    return 1 if (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1


def _fill_missing(comps, like):
    """The components left None, as zeros."""
    return [torch.zeros_like(like) if c is None else c for c in comps]


# ---------------------------------------------------------------------------
# eigen system (mhd_eigen.H, over the normal direction with the transverse
# pair in natural axis order, as evecx/evecy/evecz)

def mhd_speeds(as2, rho, Bn, Bt1, Bt2):
    ca = (Bn * Bn + Bt1 * Bt1 + Bt2 * Bt2) / rho
    cad = Bn * Bn / rho
    disc = torch.sqrt(torch.clamp((as2 + ca) ** 2 - 4.0 * as2 * cad, min=0.0))
    cs = 0.5 * ((as2 + ca) - disc)
    cf = 0.5 * ((as2 + ca) + disc)
    return cs, cf, cad


def mhd_evals(as2, un, rho, Bn, Bt1, Bt2):
    cs, cf, cad = mhd_speeds(as2, rho, Bn, Bt1, Bt2)
    scs = torch.sqrt(torch.clamp(cs, min=0.0))
    scf = torch.sqrt(cf)
    sca = torch.sqrt(cad)
    return [un - scf, un - sca, un - scs, un, un + scs, un + sca, un + scf]


def mhd_evecs(as2, rho, Bn, Bt1, Bt2):
    """(leig, reig) as 7x7 nested lists of tensors, rows of leig the left
    eigenvectors in the (rho, un, ut1, ut2, p, Bt1, Bt2) ordering, reig[n]
    [wave] (mhd_eigen.H evec{x,y,z} with bety -> bet1, betz -> bet2)."""
    cs, cf, _ = mhd_speeds(as2, rho, Bn, Bt1, Bt2)

    denom = cf - cs
    degenerate = torch.abs(denom) <= 1e-14
    den_s = torch.where(degenerate, 1.0, denom)
    alf = torch.where(degenerate, 1.0,
                      torch.where(as2 - cs < 0.0, 0.0,
                                  torch.sqrt(torch.clamp(as2 - cs, min=0.0) / den_s)))
    als = torch.where(degenerate, 0.0,
                      torch.where(cf - as2 < 0.0, 0.0,
                                  torch.sqrt(torch.clamp(cf - as2, min=0.0) / den_s)))

    bmag = torch.sqrt(Bt1 * Bt1 + Bt2 * Bt2)
    tiny_b = (torch.abs(Bt1) <= 1e-14) & (torch.abs(Bt2) <= 1e-14)
    inv_b = 1.0 / torch.where(tiny_b, 1.0, bmag)
    isq2 = 1.0 / math.sqrt(2.0)
    bet1 = torch.where(tiny_b, isq2, Bt1 * inv_b)
    bet2 = torch.where(tiny_b, isq2, Bt2 * inv_b)

    scf = torch.sqrt(cf)
    scs = torch.sqrt(torch.clamp(cs, min=0.0))
    cff = scf * alf
    css = scs * als
    S = torch.sign(Bn) + (Bn == 0.0)  # copysign(1, Bn) with sign(0) = +1
    Qf = scf * alf * S
    Qs = scs * als * S
    N = 0.5 / as2
    sqrho = torch.sqrt(rho)
    sas = torch.sqrt(as2)
    AAf = sas * alf * sqrho
    AAs = sas * als * sqrho
    rhoinv = 1.0 / rho
    z = torch.zeros_like(rho)

    leig = [
        # un - cf
        [z, -N * cff, N * Qs * bet1, N * Qs * bet2, N * alf * rhoinv,
         N * AAs * bet1 * rhoinv, N * AAs * bet2 * rhoinv],
        # un - ca
        [z, z, -0.5 * bet2, 0.5 * bet1, z, -0.5 * bet2 * S / sqrho, 0.5 * bet1 * S / sqrho],
        # un - cs
        [z, -N * css, -N * Qf * bet1, -N * Qf * bet2, N * als * rhoinv,
         -N * AAf * bet1 * rhoinv, -N * AAf * bet2 * rhoinv],
        # un
        [torch.ones_like(rho), z, z, z, -1.0 / as2, z, z],
        # un + cs
        [z, N * css, N * Qf * bet1, N * Qf * bet2, N * als * rhoinv,
         -N * AAf * bet1 * rhoinv, -N * AAf * bet2 * rhoinv],
        # un + ca
        [z, z, 0.5 * bet2, -0.5 * bet1, z, -0.5 * bet2 * S / sqrho, 0.5 * bet1 * S / sqrho],
        # un + cf
        [z, N * cff, -N * Qs * bet1, -N * Qs * bet2, N * alf * rhoinv,
         N * AAs * bet1 * rhoinv, N * AAs * bet2 * rhoinv],
    ]

    one = torch.ones_like(rho)
    reig_cols = [
        # un - cf
        [rho * alf, -cff, Qs * bet1, Qs * bet2, rho * as2 * alf, AAs * bet1, AAs * bet2],
        # un - ca
        [z, z, -bet2, bet1, z, -bet2 * S * sqrho, bet1 * S * sqrho],
        # un - cs
        [rho * als, -css, -Qf * bet1, -Qf * bet2, rho * as2 * als, -AAf * bet1, -AAf * bet2],
        # un
        [one, z, z, z, z, z, z],
        # un + cs
        [rho * als, css, Qf * bet1, Qf * bet2, rho * as2 * als, -AAf * bet1, -AAf * bet2],
        # un + ca
        [z, z, bet2, -bet1, z, -bet2 * S * sqrho, bet1 * S * sqrho],
        # un + cf
        [rho * alf, cff, -Qs * bet1, -Qs * bet2, rho * as2 * alf, AAs * bet1, AAs * bet2],
    ]
    reig = [[reig_cols[w][n] for w in range(NEIGN)] for n in range(NEIGN)]
    return leig, reig


# ---------------------------------------------------------------------------
# slope limiter (slope.H uslope, plm_limiter=1: the 2nd-order MC limiter; the
# MHD PLM feeds it per characteristic or per primitive field)

def _mc_slope(qm1, q0, qp1, flatn):
    dlft = 2.0 * (q0 - qm1)
    drgt = 2.0 * (qp1 - q0)
    dcen = 0.25 * (dlft + drgt)
    dsgn = torch.sign(dcen) + (dcen == 0.0)
    slop = torch.minimum(torch.abs(dlft), torch.abs(drgt))
    dlim = torch.where(dlft * drgt >= 0.0, slop, 0.0)
    return flatn * dsgn * torch.minimum(dlim, torch.abs(dcen))


# ---------------------------------------------------------------------------
# extended-state helpers

def ext_layout(L):
    """(QMG, UMG): the component indices of cell-centred B in the extended
    primitives and of face B in the extended conserved state."""
    return (L.NQ, L.NQ + 1, L.NQ + 2), (L.NVAR, L.NVAR + 1, L.NVAR + 2)


def cons_to_prim_ext(ux, L, eos, small_dens=1e-30):
    """ConsToPrim (mhd_util.H): extended conserved -> extended primitive."""
    QMG, UMG = ext_layout(L)
    rho = torch.clamp(ux[L.URHO], min=small_dens)
    rhoinv = 1.0 / rho
    vx = ux[L.UMX] * rhoinv
    vy = ux[L.UMY] * rhoinv
    vz = ux[L.UMZ] * rhoinv
    B = [ux[c] for c in UMG]
    rhoe = ux[L.UEDEN] - 0.5 * rho * (vx * vx + vy * vy + vz * vz) \
        - 0.5 * (B[0] ** 2 + B[1] ** 2 + B[2] ** 2)
    rhoe = torch.clamp(rhoe, min=small_dens * 1e-10)
    xn = ux[L.UFS: L.UFS + L.nspec] * rhoinv[None]
    es = eos.re(rho=rho, e=rhoe * rhoinv, xn=xn)
    comps = [None] * (L.NQ + 3)
    comps[L.QRHO] = rho
    comps[L.QU], comps[L.QV], comps[L.QW] = vx, vy, vz
    comps[L.QPRES] = es.p
    comps[L.QREINT] = rhoe
    comps[L.QTEMP] = es.T
    comps[L.QGAME] = es.p / rhoe + 1.0
    for i in range(L.nspec):
        comps[L.QFS + i] = xn[i]
    for c, bb in zip(QMG, B):
        comps[c] = bb
    return torch.stack(_fill_missing(comps, rho))


def prim_to_cons_ext(qx, L, eos):
    """PToC (mhd_util.cpp): extended primitive -> extended conserved."""
    QMG, UMG = ext_layout(L)
    rho = qx[L.QRHO]
    vx, vy, vz = qx[L.QU], qx[L.QV], qx[L.QW]
    xn = qx[L.QFS: L.QFS + L.nspec]
    es = eos.rp(rho=rho, p=qx[L.QPRES], xn=xn)
    B2 = qx[QMG[0]] ** 2 + qx[QMG[1]] ** 2 + qx[QMG[2]] ** 2
    comps = [None] * (L.NVAR + 3)
    comps[L.URHO] = rho
    comps[L.UMX], comps[L.UMY], comps[L.UMZ] = rho * vx, rho * vy, rho * vz
    comps[L.UEINT] = rho * es.e
    comps[L.UEDEN] = rho * es.e + 0.5 * rho * (vx * vx + vy * vy + vz * vz) + 0.5 * B2
    comps[L.UTEMP] = es.T
    for i in range(L.nspec):
        comps[L.UFS + i] = rho * xn[i]
    for c, qc in zip(UMG, QMG):
        comps[c] = qx[qc]
    return torch.stack(_fill_missing(comps, rho))


# ---------------------------------------------------------------------------
# HLLD on extended states -> the extended flux [NVAR+3]

def hlld_ext(qlx, qrx, d, L, eos, small_dens, small_pres):
    """HLLD flux in the unrotated extended layout (hlld.cpp). qlx / qrx are
    extended primitive interface states at face i-1/2 at i. The passives
    (rho e, species) ride the fan with the star density."""
    QMG, UMG = ext_layout(L)
    t1, t2 = _taxes(d)
    VEL = (L.QU, L.QV, L.QW)

    def to_face(qx):
        rho = torch.clamp(qx[L.QRHO], min=small_dens)
        p = torch.clamp(qx[L.QPRES], min=small_pres)
        xn = qx[L.QFS: L.QFS + L.nspec]
        es = eos.rp(rho=rho, p=p, xn=xn)
        return MhdFaceState(rho=rho, un=qx[VEL[d]], ut1=qx[VEL[t1]], ut2=qx[VEL[t2]], p=p,
                            Bt1=qx[QMG[t1]], Bt2=qx[QMG[t2]], e=es.e), es

    sl, esl = to_face(qlx)
    sr, esr = to_face(qrx)
    Bn = 0.5 * (qlx[QMG[d]] + qrx[QMG[d]])  # both carry the exact face B
    gamma = 0.5 * (esl.gam1 + esr.gam1)

    # passives: specific quantities phi advected through the fan
    pass_specific = ([sl.e] + [qlx[L.QFS + i] for i in range(L.nspec)],
                     [sr.e] + [qrx[L.QFS + i] for i in range(L.nspec)])
    F7, SM, Fpass = _hlld_with_passives(sl, sr, Bn, gamma, pass_specific)

    comps = [None] * (L.NVAR + 3)
    comps[L.URHO] = F7[0]
    mom = (L.UMX, L.UMY, L.UMZ)
    comps[mom[d]] = F7[1]
    comps[mom[t1]] = F7[2]
    comps[mom[t2]] = F7[3]
    comps[L.UEDEN] = F7[4]
    comps[UMG[t1]] = F7[5]
    comps[UMG[t2]] = F7[6]
    comps[UMG[d]] = torch.zeros_like(F7[0])
    comps[L.UEINT] = Fpass[0]
    for i in range(L.nspec):
        comps[L.UFS + i] = Fpass[1 + i]
    return torch.stack(_fill_missing(comps, F7[0]))


def _hlld_with_passives(sl, sr, Bn, gamma, pass_specific):
    """HLLD (Miyoshi-Kusano, hlld.cpp) with per-mass passive scalars:
    U_pass = phi rho in each state, U*_pass = phi rho*, U** = U*."""
    F7, SM = hlld(sl, sr, Bn, gamma)

    # the wave structure again, for the passives' selection
    cfl = fast_speed(sl.rho, sl.p, Bn, sl.Bt1, sl.Bt2, gamma)
    cfr = fast_speed(sr.rho, sr.p, Bn, sr.Bt1, sr.Bt2, gamma)
    SL = torch.minimum(sl.un - cfl, sr.un - cfr)
    SR = torch.maximum(sl.un + cfl, sr.un + cfr)
    ptL = sl.p + 0.5 * (Bn ** 2 + sl.Bt1 ** 2 + sl.Bt2 ** 2)
    ptR = sr.p + 0.5 * (Bn ** 2 + sr.Bt1 ** 2 + sr.Bt2 ** 2)
    dL = sl.rho * (SL - sl.un)
    dR = sr.rho * (SR - sr.un)
    SM2 = (dR * sr.un - dL * sl.un - ptR + ptL) / (dR - dL)
    rhoLs = dL / (SL - SM2)
    rhoRs = dR / (SR - SM2)
    SLs = SM2 - torch.abs(Bn) / torch.sqrt(torch.clamp(rhoLs, min=1e-30))
    SRs = SM2 + torch.abs(Bn) / torch.sqrt(torch.clamp(rhoRs, min=1e-30))

    Fp = []
    for phiL, phiR in zip(*pass_specific):
        uL = phiL * sl.rho
        uR = phiR * sr.rho
        fL = sl.un * uL
        fR = sr.un * uR
        usL = phiL * rhoLs
        usR = phiR * rhoRs
        fLs = fL + SL * (usL - uL)
        fRs = fR + SR * (usR - uR)
        # the ** state equals the * state for passives
        f = torch.where(SL > 0.0, fL,
            torch.where(SLs >= 0.0, fLs,
            torch.where(SM2 >= 0.0, fLs,
            torch.where(SRs >= 0.0, fRs,
            torch.where(SR >= 0.0, fRs, fR)))))
        Fp.append(f)
    return F7, SM, Fp


# ---------------------------------------------------------------------------
# interface states

def _smhd(qx, QMG, VEL, d, t1, t2, rho, dBn):
    """The magnetic cross-talk sources (Miniati Eq. 32-33) in the rotated
    eigen slots (rho, un, ut1, ut2, p, Bt1, Bt2): the reference stores
    B{x,y,z}/rho in its fixed x/y/z velocity slots (mhd_plm.cpp:150-152),
    permuted here to (n, t1, t2)."""
    B = [qx[QMG[0]], qx[QMG[1]], qx[QMG[2]]]
    smhd = [torch.zeros_like(rho), B[d] / rho, B[t1] / rho, B[t2] / rho,
            qx[QMG[0]] * qx[VEL[0]] + qx[QMG[1]] * qx[VEL[1]] + qx[QMG[2]] * qx[VEL[2]],
            qx[VEL[t1]], qx[VEL[t2]]]
    return [s * dBn for s in smhd]


def _finish(comps, L, eos, srcQ, hdt, small_dens, like):
    """rho e from (rho, p, X), then + dt/2 srcQ; the extended state."""
    xn = torch.stack([comps[L.QFS + i] for i in range(L.nspec)]) \
        if L.nspec else torch.zeros((0,) + like.shape, dtype=like.dtype, device=like.device)
    es = eos.rp(rho=comps[L.QRHO], p=comps[L.QPRES], xn=xn)
    comps[L.QREINT] = es.e * comps[L.QRHO]
    if srcQ is not None:
        comps[L.QRHO] = torch.clamp(comps[L.QRHO] + hdt * srcQ[L.QRHO], min=small_dens)
        for c in (L.QU, L.QV, L.QW, L.QPRES, L.QREINT):
            comps[c] = comps[c] + hdt * srcQ[c]
    return torch.stack(_fill_missing(comps, like))


def ppm_mhd(qx, cs, srcQ, flatn, b, d, dt, dx_d, L, eos, small_dens, small_pres):
    """PPM interface states of the CTU-CT scheme (reference
    `mhd_ppm.cpp:509`): the parabolic reconstruction of the 7 eigen fields,
    per-wave integrals under the parabola with the Stone et al. (2008) eq.
    44-45 piecewise-linear fallback for waves moving away from the
    interface, and fastest-wave reference states."""
    from castro_tpu_torch.ops.ppm import ppm_int_profile_single, ppm_reconstruct

    QMG, _ = ext_layout(L)
    t1, t2 = _taxes(d)
    VEL = (L.QU, L.QV, L.QW)
    dtdx = dt / dx_d
    hdt = 0.5 * dt

    rho = qx[L.QRHO]
    as2 = cs * cs
    Bn_c = qx[QMG[d]]
    Bt1_c = qx[QMG[t1]]
    Bt2_c = qx[QMG[t2]]
    un = qx[VEL[d]]

    fields = [qx[L.QRHO], qx[VEL[d]], qx[VEL[t1]], qx[VEL[t2]], qx[L.QPRES], Bt1_c, Bt2_c]

    lam = mhd_evals(as2, un, rho, Bn_c, Bt1_c, Bt2_c)
    leig, reig = mhd_evecs(as2, rho, Bn_c, Bt1_c, Bt2_c)

    dBn = (shifted(b[d], 1, d) - b[d]) / dx_d
    smhd = _smhd(qx, QMG, VEL, d, t1, t2, rho, dBn)

    # parabolae + per-wave integrals (Ip[n][ii], Im[n][ii])
    Ip = [[None] * NEIGN for _ in range(NEIGN)]
    Im = [[None] * NEIGN for _ in range(NEIGN)]
    ref_l = [None] * NEIGN
    ref_r = [None] * NEIGN
    for n in range(NEIGN):
        sm, sp = ppm_reconstruct(fields[n], flatn, d)
        slope = 0.5 * dtdx * (sp - sm)
        for ii in range(NEIGN):
            Ipt, Imt = ppm_int_profile_single(sm, sp, fields[n], lam[ii], dtdx)
            # Stone et al. eq. 44-45: waves moving away from the interface
            # take a piecewise-linear slope instead
            Ip[n][ii] = torch.where(lam[ii] >= 0.0, Ipt, slope)
            Im[n][ii] = torch.where(lam[ii] <= 0.0, Imt, slope)
        # reference states: the fastest wave toward each interface
        ref_l[n] = ppm_int_profile_single(sm, sp, fields[n], lam[NEIGN - 1], dtdx)[0]
        ref_r[n] = ppm_int_profile_single(sm, sp, fields[n], lam[0], dtdx)[1]

    def char_sum(ref, I, plus):
        summ = [torch.zeros_like(rho) for _ in range(NEIGN)]
        lam_ref = lam[NEIGN - 1] if plus else lam[0]
        for ii in range(NEIGN):
            toward = (lam[ii] >= 0.0) if plus else (lam[ii] <= 0.0)
            LdQ = 0.0
            for n in range(NEIGN):
                LdQ = LdQ + torch.where(toward, leig[ii][n] * (ref[n] - I[n][ii]),
                                        (lam_ref - lam[ii]) * leig[ii][n] * I[n][ii])
            for n in range(NEIGN):
                summ[n] = summ[n] + LdQ * reig[n][ii]
        return summ

    summ_p = char_sum(ref_l, Ip, True)
    summ_m = char_sum(ref_r, Im, False)

    def build(ref, summ, face_Bn, left):
        comps = [None] * (L.NQ + 3)
        comps[L.QRHO] = torch.clamp(ref[IRHO] - summ[IRHO] + hdt * smhd[IRHO], min=small_dens)
        comps[VEL[d]] = ref[IU] - summ[IU] + hdt * smhd[IU]
        comps[VEL[t1]] = ref[IV] - summ[IV] + hdt * smhd[IV]
        comps[VEL[t2]] = ref[IW] - summ[IW] + hdt * smhd[IW]
        comps[L.QPRES] = torch.clamp(ref[IP] - summ[IP] + hdt * smhd[IP], min=small_pres)
        comps[QMG[d]] = face_Bn
        comps[QMG[t1]] = ref[IBT] - summ[IBT] + hdt * smhd[IBT]
        comps[QMG[t2]] = ref[IBTT] - summ[IBTT] + hdt * smhd[IBTT]
        # species advect under the entropy (u) wave
        for i in range(L.nspec):
            X = qx[L.QFS + i]
            smX, spX = ppm_reconstruct(X, flatn, d)
            IpX, ImX = ppm_int_profile_single(smX, spX, X, un, dtdx)
            comps[L.QFS + i] = IpX if left else ImX
        return comps

    ql = _finish(build(ref_l, summ_p, shifted(b[d], 1, d), True), L, eos, srcQ, hdt,
                 small_dens, rho)
    qr = _finish(build(ref_r, summ_m, b[d], False), L, eos, srcQ, hdt, small_dens, rho)
    return shifted(ql, -1, 1 + d), qr


def plm_mhd(qx, cs, srcQ, flatn, b, d, dt, dx_d, L, eos, small_dens, small_pres,
            limit_characteristic=True):
    """Interface states (qleft at the face from cell i-1 -> qm; qright from
    cell i -> qp) with the Miniati Eq. 32-33 magnetic source terms and the
    half-dt characteristic trace (mhd_plm.cpp). Faces i-1/2 at i."""
    QMG, _ = ext_layout(L)
    t1, t2 = _taxes(d)
    VEL = (L.QU, L.QV, L.QW)
    dtdx = dt / dx_d

    rho = qx[L.QRHO]
    as2 = cs * cs
    Bn_c = qx[QMG[d]]
    Bt1_c = qx[QMG[t1]]
    Bt2_c = qx[QMG[t2]]
    un = qx[VEL[d]]

    # the eigen-space fields (rho, un, ut1, ut2, p, Bt1, Bt2)
    fields = [qx[L.QRHO], qx[VEL[d]], qx[VEL[t1]], qx[VEL[t2]], qx[L.QPRES], Bt1_c, Bt2_c]

    lam = mhd_evals(as2, un, rho, Bn_c, Bt1_c, Bt2_c)
    leig, reig = mhd_evecs(as2, rho, Bn_c, Bt1_c, Bt2_c)

    dBn = (shifted(b[d], 1, d) - b[d]) / dx_d
    smhd = _smhd(qx, QMG, VEL, d, t1, t2, rho, dBn)

    # slopes
    if limit_characteristic:
        dq = [torch.zeros_like(rho) for _ in range(NEIGN)]
        for ii in range(NEIGN):
            W0 = sum(leig[ii][n] * shifted(fields[n], -1, d) for n in range(NEIGN))
            W1 = sum(leig[ii][n] * fields[n] for n in range(NEIGN))
            W2 = sum(leig[ii][n] * shifted(fields[n], 1, d) for n in range(NEIGN))
            dW = _mc_slope(W0, W1, W2, flatn)
            for n in range(NEIGN):
                dq[n] = dq[n] + dW * reig[n][ii]
    else:
        dq = [_mc_slope(shifted(f, -1, d), f, shifted(f, 1, d), flatn) for f in fields]

    # characteristic projection, summing over all eigenvalues (HLLD mode)
    summ_p = [torch.zeros_like(rho) for _ in range(NEIGN)]
    summ_m = [torch.zeros_like(rho) for _ in range(NEIGN)]
    for ii in range(NEIGN):
        Ldq = sum(leig[ii][n] * dq[n] for n in range(NEIGN))
        wp = (1.0 - dtdx * lam[ii]) * Ldq
        wm = -(1.0 + dtdx * lam[ii]) * Ldq
        for n in range(NEIGN):
            summ_p[n] = summ_p[n] + wp * reig[n][ii]
            summ_m[n] = summ_m[n] + wm * reig[n][ii]

    hdt = 0.5 * dt

    def build(summ, face_Bn, left):
        comps = [None] * (L.NQ + 3)
        comps[L.QRHO] = torch.clamp(rho + 0.5 * summ[IRHO] + hdt * smhd[IRHO], min=small_dens)
        comps[VEL[d]] = un + 0.5 * summ[IU] + hdt * smhd[IU]
        comps[VEL[t1]] = fields[2] + 0.5 * summ[IV] + hdt * smhd[IV]
        comps[VEL[t2]] = fields[3] + 0.5 * summ[IW] + hdt * smhd[IW]
        comps[L.QPRES] = torch.clamp(qx[L.QPRES] + 0.5 * summ[IP] + hdt * smhd[IP],
                                     min=small_pres)
        comps[QMG[d]] = face_Bn
        comps[QMG[t1]] = Bt1_c + 0.5 * summ[IBT] + hdt * smhd[IBT]
        comps[QMG[t2]] = Bt2_c + 0.5 * summ[IBTT] + hdt * smhd[IBTT]
        # species: the upwind-predictor advection
        for i in range(L.nspec):
            X = qx[L.QFS + i]
            dX = _mc_slope(shifted(X, -1, d), X, shifted(X, 1, d), flatn)
            if left:
                comps[L.QFS + i] = X + 0.5 * (1.0 - dtdx * un) * dX
            else:
                comps[L.QFS + i] = X - 0.5 * (1.0 + dtdx * un) * dX
        return comps

    # qleft: the left state of face i+1/2 (the reference stores it at i+1),
    # its face B b[d] at i+1
    ql = _finish(build(summ_p, shifted(b[d], 1, d), True), L, eos, srcQ, hdt, small_dens, rho)
    qr = _finish(build(summ_m, b[d], False), L, eos, srcQ, hdt, small_dens, rho)
    # face i-1/2 at i: qm (left) is qleft shifted from cell i-1
    return shifted(ql, -1, 1 + d), qr


# ---------------------------------------------------------------------------
# edge electric fields (electric.cpp; Gardiner-Stone with upwinded
# cell-centred E derivatives)

def _ecen(qx, k, L):
    """Cell-centred E_k = -(v x B)_k (mhd_util.H electric)."""
    QMG, _ = ext_layout(L)
    a1 = (k + 1) % 3
    a2 = (k + 2) % 3
    VEL = (L.QU, L.QV, L.QW)
    return -qx[VEL[a1]] * qx[QMG[a2]] + qx[VEL[a2]] * qx[QMG[a1]]


def electric_edge(k, qx, flx_a1, flx_a2, L):
    """E_k on the edges (k-line at a1-1/2, a2-1/2), (k, a1, a2) cyclic.

    flx_a1 / flx_a2: the extended fluxes through a1- / a2-faces.
    electric_edge_x (electric.cpp:9-165) with the cyclic axis map x -> k,
    y -> a1, z -> a2."""
    QMG, UMG = ext_layout(L)
    a1 = (k + 1) % 3
    a2 = (k + 2) % 3

    Ec = _ecen(qx, k, L)
    sp = Ec.dim()  # spatial rank (2 in 2D, 3 in 3D); fluxes carry a component axis

    def sh(arr, off_a1=0, off_a2=0):
        out = arr
        if off_a1:
            out = shifted(out, off_a1, a1 if out.dim() == sp else 1 + a1)
        if off_a2:
            out = shifted(out, off_a2, a2 if out.dim() == sp else 1 + a2)
        return out

    F1_B2 = flx_a1[UMG[a2]]   # flux of B_a2 through a1 faces = -E_k there
    F2_B1 = flx_a2[UMG[a1]]   # flux of B_a1 through a2 faces = +E_k there
    F1_rho = flx_a1[L.URHO]
    F2_rho = flx_a2[L.URHO]

    def upw(sel, a, bb):
        return torch.where(sel > 0.0, a, torch.where(sel < 0.0, bb, 0.5 * (a + bb)))

    # dE/da1 at (a1-3/4, a2-1/2)
    a_ = 2.0 * (-sh(F1_B2, 0, -1) - sh(Ec, -1, -1))
    b_ = 2.0 * (-F1_B2 - sh(Ec, -1, 0))
    d1 = upw(sh(F2_rho, -1, 0), a_, b_)
    # dE/da1 at (a1-1/4, a2-1/2)
    a_ = 2.0 * (sh(Ec, 0, -1) + sh(F1_B2, 0, -1))
    b_ = 2.0 * (Ec + F1_B2)
    d2 = upw(F2_rho, a_, b_)
    dd1 = 0.125 * (d1 - d2)

    # dE/da2 at (a1-1/2, a2-3/4)
    a_ = 2.0 * (sh(F2_B1, -1, 0) - sh(Ec, -1, -1))
    b_ = 2.0 * (F2_B1 - sh(Ec, 0, -1))
    d1 = upw(sh(F1_rho, 0, -1), a_, b_)
    # dE/da2 at (a1-1/2, a2-1/4)
    a_ = 2.0 * (sh(Ec, -1, 0) - sh(F2_B1, -1, 0))
    b_ = 2.0 * (Ec - F2_B1)
    d2 = upw(F1_rho, a_, b_)
    dd2 = 0.125 * (d1 - d2)

    return 0.25 * (-F1_B2 - sh(F1_B2, 0, -1) + sh(F2_B1, -1, 0) + F2_B1) + dd1 + dd2


# ---------------------------------------------------------------------------
# corner coupling, the 2D transverse pass, the half step (ct_upwind.cpp)

def _states(ur, ul, dFs, rows_fn, L, eos, small_dens):
    """(qr, ql): the two face states, each u less every dF(offset) of
    `dFs` in turn but the rows that `rows_fn(n, u_face, offset)` returns
    (None: keep them), UTEMP zeroed, to extended primitives. ur is the '-'
    state (cell i), ul the '+' state (cell i-1, offset -1)."""
    outs = []
    for u_face, off in ((ur, 0), (ul, -1)):
        ut = u_face
        for dF in dFs:
            ut = ut - dF(off)
        rows = []
        for n in range(ut.shape[0]):
            if n == L.UTEMP:
                rows.append(torch.zeros_like(ut[n]))
                continue
            r = rows_fn(n, u_face, off)
            rows.append(ut[n] if r is None else r)
        outs.append(cons_to_prim_ext(torch.stack(rows), L, eos, small_dens))
    return outs[0], outs[1]


def _flux_diff(flx, td, off, axis_off, scale):
    """scale * (flx shifted +1 along td - flx), both shifted by `off` along
    the axis `axis_off` of the component-major array."""
    hi = shifted(flx, 1, 1 + td)
    lo = flx
    if off:
        hi = shifted(hi, off, 1 + axis_off)
        lo = shifted(lo, off, 1 + axis_off)
    return scale * (hi - lo)


def corner_couple(ur, ul, flxd2, Ed1, Ed3, d1, d2, d3, dt, dx, L, eos, small_dens):
    """MM Eq. 37-39: the d1-face conserved states corrected with the d2
    transverse flux difference and the EMF terms; extended primitive
    states (qr, ql). ur = '-' state (cell i), ul = '+' state (cell i-1)."""
    _, UMG = ext_layout(L)
    sgn = _eps(d1, d2, d3)
    cdtdx = dt / (3.0 * dx[d1])

    # Ed3 differenced along d2 (the normal-B update, Eq. 38): the face is
    # shared by both states, so no d1 shift
    dEd3 = shifted(Ed3, 1, d2) - Ed3

    def dEd1(off_d1):
        # the four-corner Ed1 difference (the in-plane B, Eq. 39)
        err = shifted(shifted(Ed1, 1, d2), 1, d3)
        elr = shifted(Ed1, 1, d3)
        erl = shifted(Ed1, 1, d2)
        ell = Ed1
        if off_d1:
            err = shifted(err, off_d1, d1)
            elr = shifted(elr, off_d1, d1)
            erl = shifted(erl, off_d1, d1)
            ell = shifted(ell, off_d1, d1)
        return (err - elr) + (erl - ell)

    def rows(n, u_face, off):
        if n == UMG[d1]:
            return u_face[n] - sgn * cdtdx * dEd3
        if n == UMG[d3]:
            return u_face[n] + sgn * 0.5 * cdtdx * dEd1(off)
        if n == UMG[d2]:
            return u_face[n]
        return None

    return _states(ur, ul, [lambda off: _flux_diff(flxd2, d2, off, d1, cdtdx)], rows, L, eos,
                   small_dens)


def transverse_2d(ur, ul, flxd2, Ez, d1, d2, dt, dx, L, eos, small_dens):
    """The 2D CTU transverse correction of the d1-face states with the d2
    fluxes and the corner Ez (the dimensional reduction of MM's corner
    coupling: one transverse pass with the dt/2 factor). The reference has
    no 2D MHD build (every `Exec/mhd_tests/*/GNUmakefile` sets DIM=3), so
    this reduction is the JAX package's own:
      * gas + out-of-plane Bz: the transverse flux difference (F_d2(Bz) is
        the in-plane electric field, so the flux term is Bz's CT update);
      * the normal B (UMG[d1]): the Ez edge difference along d2, its own CT
        half update (the face is shared by both states);
      * the in-plane transverse B (UMG[d2]): unchanged (its d2 flux is 0).
    ur = '-' state (cell i), ul = '+' state (cell i-1)."""
    _, UMG = ext_layout(L)
    sgn = _eps(d1, d2, 3 - d1 - d2)
    hdtd2 = 0.5 * dt / dx[d2]
    # Ez differenced along d2 at the shared d1-face (no d1 shift)
    dEz = shifted(Ez, 1, d2) - Ez

    def rows(n, u_face, off):
        if n == UMG[d1]:
            return u_face[n] - sgn * hdtd2 * dEz
        if n == UMG[d2]:
            return u_face[n]
        return None

    return _states(ur, ul, [lambda off: _flux_diff(flxd2, d2, off, d1, hdtd2)], rows, L, eos,
                   small_dens)


def half_step(ur, ul, flxd1, flxd2, Ed, Ed1, Ed2, d, d1, d2, dt, dx, L, eos, small_dens):
    """MM Eq. 44-46: the final double-transverse correction of the d-face
    states with the corner-coupled fluxes and EMFs."""
    _, UMG = ext_layout(L)
    hdtdx = 0.5 * dt / dx[d]
    sgn = -1 * _eps(d, d1, d2)

    def sh3(E, od=0, od1=0, od2=0):
        out = E
        if od:
            out = shifted(out, od, d)
        if od1:
            out = shifted(out, od1, d1)
        if od2:
            out = shifted(out, od2, d2)
        return out

    # the normal B (Eq. 45): Ed1 differenced along d2, Ed2 along d1; the
    # shared face, never shifted
    dBn = (sh3(Ed1, 0, 0, 1) - Ed1) - (sh3(Ed2, 0, 1, 0) - Ed2)

    def dBd1(off_d):
        # the in-plane Bd1 (Eq. 46); the '+' state shifts every corner by -1
        # along d
        return ((sh3(Ed, off_d, 1, 1) - sh3(Ed, off_d, 1, 0))
                + (sh3(Ed, off_d, 0, 1) - sh3(Ed, off_d, 0, 0))
                - (sh3(Ed2, off_d + 1, 1, 0) - sh3(Ed2, off_d, 1, 0))
                - (sh3(Ed2, off_d + 1, 0, 0) - sh3(Ed2, off_d, 0, 0)))

    def dBd2(off_d):
        # the in-plane Bd2 (Eq. 46)
        return ((sh3(Ed, off_d, 1, 1) - sh3(Ed, off_d, 0, 1))
                + (sh3(Ed, off_d, 1, 0) - sh3(Ed, off_d, 0, 0))
                - (sh3(Ed1, off_d + 1, 0, 1) - sh3(Ed1, off_d, 0, 1))
                - (sh3(Ed1, off_d + 1, 0, 0) - sh3(Ed1, off_d, 0, 0)))

    def rows(n, u_face, off):
        if n == UMG[d]:
            return u_face[n] - sgn * hdtdx * dBn
        if n == UMG[d1]:
            return u_face[n] + sgn * 0.5 * hdtdx * dBd1(off)
        if n == UMG[d2]:
            return u_face[n] - sgn * 0.5 * hdtdx * dBd2(off)
        return None

    return _states(ur, ul, [lambda off: _flux_diff(flxd1, d1, off, d, hdtdx),
                            lambda off: _flux_diff(flxd2, d2, off, d, hdtdx)], rows, L, eos,
                   small_dens)


# ---------------------------------------------------------------------------
# half-time primitives (prim_half + qflux, mhd_util)

def prim_half(qx, flxs, dt, dx, L, eos):
    """q at n+1/2 (MM Eq. 48): q - dt/2 (dW/dU . div F). `flxs`: the
    extended fluxes, one a dimension (3 in 3D, 2 in 2D)."""
    QMG, UMG = ext_layout(L)
    divF = 0.0
    for d, flx in enumerate(flxs):
        divF = divF + (shifted(flx, 1, 1 + d) - flx) / dx[d]

    rho = qx[L.QRHO]
    rhoinv = 1.0 / rho
    vx, vy, vz = qx[L.QU], qx[L.QV], qx[L.QW]
    xn = qx[L.QFS: L.QFS + L.nspec]
    es = eos.rp(rho=rho, p=qx[L.QPRES], xn=xn)

    qfl = [None] * (L.NQ + 3)
    qfl[L.QRHO] = divF[L.URHO]
    qfl[L.QU] = (divF[L.UMX] - divF[L.URHO] * vx) * rhoinv
    qfl[L.QV] = (divF[L.UMY] - divF[L.URHO] * vy) * rhoinv
    qfl[L.QW] = (divF[L.UMZ] - divF[L.URHO] * vz) * rhoinv
    for i in range(L.nspec):
        qfl[L.QFS + i] = (divF[L.UFS + i] - divF[L.URHO] * qx[L.QFS + i]) * rhoinv
    # dp = dpdr_e drho + dpde (d(rho e) - e drho) / rho, with d(rho e) = dE -
    # v.dm + (v^2/2) drho - B.dB (the reference's (rho, p) form of
    # mhd_util.H qflux, rearranged)
    F_rhoe = (divF[L.UEDEN]
              - vx * divF[L.UMX] - vy * divF[L.UMY] - vz * divF[L.UMZ]
              + 0.5 * (vx * vx + vy * vy + vz * vz) * divF[L.URHO]
              - qx[QMG[0]] * divF[UMG[0]] - qx[QMG[1]] * divF[UMG[1]]
              - qx[QMG[2]] * divF[UMG[2]])
    qfl[L.QPRES] = es.dpdr_e * divF[L.URHO] + es.dpde * (F_rhoe - es.e * divF[L.URHO]) * rhoinv
    for k in range(3):
        qfl[QMG[k]] = divF[UMG[k]]
    return qx - 0.5 * dt * torch.stack(_fill_missing(qfl, rho))


__all__ = ["plm_mhd", "ppm_mhd", "hlld_ext", "electric_edge", "corner_couple",
           "transverse_2d", "half_step", "prim_half", "cons_to_prim_ext",
           "prim_to_cons_ext", "ext_layout", "mhd_evals", "mhd_evecs"]
