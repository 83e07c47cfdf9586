"""Inter-level operators of the AMR hierarchy, ratio 2: conservative
prolongation (FillPatch / FillCoarsePatch), restriction (avgDown), the
masks' coarsening and refinement, and the face-flux coarsening of the flux
registers.

Counterpart of `castro_tpu/ops/interlevel.py` (reference: AMReX
CellConservativeLinear, `average_down`, `FluxRegister::CrseInit/FineAdd/
Reflux`, `Source/driver/Castro.cpp:2549-2700`). Dense whole-array torch
ops, as the JAX package leaves them to XLA. The face operators serve MHD
on AMR (`prolong_face`, the divergence-free face fillpatch; `restrict_face`
and `restrict_edge`, the CT flux register) and `restrict_face` the phi
flux register of composite gravity.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import shifted


def _mc_slope(c, ax):
    """Monotonized-central limited slope (per coarse cell) along axis ax."""
    dl = c - shifted(c, -1, ax)
    dr = shifted(c, 1, ax) - c
    dc = 0.5 * (dl + dr)
    s = torch.sign(dc)
    mag = torch.minimum(dc.abs(), 2.0 * torch.minimum(dl.abs(), dr.abs()))
    return torch.where(dl * dr > 0.0, s * mag, torch.zeros_like(dc))


def _interleave(lo, hi, ax):
    """[.., n, ..] pairs -> [.., 2n, ..] with lo at even and hi at odd indices."""
    st = torch.stack([lo, hi], dim=ax + 1)
    return st.reshape(st.shape[:ax] + (2 * lo.shape[ax],) + st.shape[ax + 2:])


def prolong(c, dim, comp_axes=1, conservative=True):
    """Coarse -> fine (ratio 2), limited-linear and mean-preserving.

    c: [..., n1, n2, ...] with `comp_axes` leading non-spatial axes. A fine
    child is c + sum_d (+-1/4) slope_d, every slope MC-limited on the
    coarse field (AMReX CellConservativeLinear), which keeps the operator
    symmetric under an exchange of axes. With conservative=False each
    child takes its parent's value."""
    slopes = [_mc_slope(c, comp_axes + d) for d in range(dim)] if conservative else None
    out = c
    for d in range(dim):
        ax = comp_axes + d
        if conservative:
            lo = out - 0.25 * slopes[d]
            hi = out + 0.25 * slopes[d]
        else:
            lo = hi = out
        out = _interleave(lo, hi, ax)
        if conservative:
            # the slopes not yet applied, upsampled along this axis
            for k in range(d + 1, dim):
                slopes[k] = torch.repeat_interleave(slopes[k], 2, dim=ax)
    return out


def restrict(f, dim, comp_axes=1):
    """Fine -> coarse volume average (reference avgDown; Cartesian)."""
    out = f
    for d in range(dim):
        ax = comp_axes + d
        n = out.shape[ax]
        out = out.reshape(out.shape[:ax] + (n // 2, 2) + out.shape[ax + 1:]).mean(dim=ax + 1)
    return out


def restrict_mask(m, dim):
    """Coarsen a boolean mask: a coarse cell is covered iff all its
    children are."""
    out = m
    for d in range(dim):
        n = out.shape[d]
        out = out.reshape(out.shape[:d] + (n // 2, 2) + out.shape[d + 1:]).all(dim=d + 1)
    return out


def prolong_mask(m, dim):
    """Refine a boolean mask: each coarse cell's value to its children."""
    out = m
    for d in range(dim):
        out = torch.repeat_interleave(out, 2, dim=d)
    return out


def restrict_face(bf, d, dim):
    """Fine -> coarse face restriction: coarse face I-1/2 at I is the area
    mean of its 2^(dim-1) fine subfaces (the even fine faces along the
    normal, pair means across it)."""
    idx = [slice(None)] * bf.dim()
    idx[d] = slice(0, None, 2)
    out = bf[tuple(idx)]
    for k in range(dim):
        if k == d:
            continue
        n = out.shape[k]
        out = out.reshape(out.shape[:k] + (n // 2, 2) + out.shape[k + 1:]).mean(dim=k + 1)
    return out


def prolong_face(bc, d, dim):
    """Divergence-free face prolongation (ratio 2) of one face field.

    bc: the coarse face array, face I-1/2 at index I, with n+1 entries
    along the normal d (the caller slices one extra hi face from the grown
    coarse field) and n across it. Fine faces on coarse face planes (even
    fine index 2I) copy the coarse value, constant over their 2^(dim-1)
    transverse children; the mid-plane fine face (odd index) is the mean of
    the two bracketing coarse faces. With every dim field prolonged so,
    each fine cell's divergence equals its parent's, so zero stays zero
    (the CT analog of AMReX face_divfree interpolation; reference MHD
    fillpatch, `Source/mhd/Castro_mhd.cpp` Mag_Type StateData). Returns 2n
    entries along every axis (fine face 2n is dropped: the at-index
    convention stores faces 0 .. 2n-1)."""
    n = bc.shape[d]
    lo = bc.narrow(d, 0, n - 1)
    out = _interleave(lo, 0.5 * (lo + bc.narrow(d, 1, n - 1)), d)
    for k in range(dim):
        if k != d:
            out = torch.repeat_interleave(out, 2, dim=k)
    return out


def restrict_edge(E, k, dim):
    """Edge-EMF restriction of the CT flux register (Balsara-style EMF
    averaging at coarse-fine boundaries): E_k lives on k-directed edges at
    (a1-1/2, a2-1/2) at (i_a1, i_a2), cell-centred along k. Coarse edges
    are the even fine edges across k; along k a coarse edge is the mean of
    its 2 fine edges. In 2D (k out of plane) a corner subsample."""
    idx = [slice(None)] * E.dim()
    for a in range(dim):
        if a != k:
            idx[a] = slice(0, None, 2)
    out = E[tuple(idx)]
    if k < dim:
        n = out.shape[k]
        out = out.reshape(out.shape[:k] + (n // 2, 2) + out.shape[k + 1:]).mean(dim=k + 1)
    return out


def coarsen_flux(F, d, dim, comp_axes=1):
    """Coarsen a face-registered flux density along direction d: coarse
    face i is fine face 2i, and across d the fine faces are averaged in
    pairs (flux densities; Cartesian areas are uniform)."""
    ax_d = comp_axes + d
    idx = [slice(None)] * F.dim()
    idx[ax_d] = slice(0, None, 2)
    out = F[tuple(idx)]
    for k in range(dim):
        if k == d:
            continue
        ax = comp_axes + k
        n = out.shape[ax]
        out = out.reshape(out.shape[:ax] + (n // 2, 2) + out.shape[ax + 1:]).mean(dim=ax + 1)
    return out
