"""The nine step kernels against their plain versions on the card, at the
state layouts of the reacting configurations: 7, 13 and 19 species (iso7,
aprox13, aprox19), the shock flag, hybrid momenta and an aux component.

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present. On the card: `python -m pytest -m cuda tests/test_torch_cuda_layouts.py`.

The kernels handle the passives one at a time at run-time offsets; the
tiled and pointwise kernels repeat their plain versions' operations in the
same order (the species sums in species order), so they are held bit for
bit. prim_aux and clean_fill evaluate the EOS's cv as k_B/m_u over mu
(gamma-1), one rounding away from torch's scalar-over-tensor, and are held
to 2e-5 |plain| in float32 and 1e-9 in float64 (tests/test_torch_cuda.py).
The grid is the ragged 37 x 29 x 45 of the face kernels' tests.
"""

import numpy as np
import pytest
import torch

from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.network import GeneralNullNetwork
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.advection_util import ctoprim
from castro_tpu_torch.ops.ctu import _bnd_masks
from castro_tpu_torch.ops.flatten import uflatten
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trans import term_bundle
from castro_tpu_torch.state import StateLayout

pytestmark = pytest.mark.cuda

NG = 4
SHAPE = (37, 29, 45)
DX = (1.0 / 12, 1.0 / 16, 1.0 / 20)
DT = 2e-3
SMALL = dict(small_dens=1e-12, small_temp=1e-12, small_pres=1e-20, small_ener=1e-200)
TOL = {torch.float64: 1e-9, torch.float32: 2e-5}
# (nspec, naux, shock_var, hybrid_momentum)
LAYOUTS = [(7, 0, False, False), (13, 0, False, False), (19, 0, False, False),
           (7, 0, True, False), (3, 0, False, True), (7, 1, False, False),
           (19, 1, True, True)]
LAYOUT_IDS = ["iso7", "aprox13", "aprox19", "iso7-shock", "3spec-hybrid", "iso7-aux",
              "aprox19-shock-hybrid-aux"]
CASES = pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _layout(layout, dim=3):
    nspec, naux, shock, hybrid = layout
    return StateLayout(dim=dim, nspec=nspec, naux=naux, shock_var=shock,
                       hybrid_momentum=hybrid)


def _eos(L):
    names = ("He4", "C12", "O16", "Ne20", "Mg24", "Si28", "Fe56")
    net = GeneralNullNetwork(spec_names=[names[i % len(names)] for i in range(L.nspec)])
    return GammaLawEos(1.4, network=net, assume_neutral=False)


def _state(L, seed, dtype, device, shape=SHAPE, bad_cells=False):
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.5, 1.5, shape)
    vel = rng.uniform(-0.4, 0.4, (3,) + shape)
    rhoe = rng.uniform(0.3, 2.0, shape) / 0.4
    u = np.zeros((L.NVAR,) + shape)
    u[L.URHO] = rho
    u[L.UMX:L.UMZ + 1] = rho * vel
    u[L.UEINT] = rhoe
    u[L.UEDEN] = rhoe + 0.5 * rho * (vel ** 2).sum(0)
    u[L.UTEMP] = 1.0
    x = rng.uniform(0.0, 1.0, (L.nspec,) + shape)
    u[L.UFS:L.UFS + L.nspec] = rho * x / x.sum(0)
    if L.naux:
        u[L.UFX:L.UFX + L.naux] = rho * rng.uniform(0.4, 0.6, (L.naux,) + shape)
    if L.shock_var:
        u[L.USHK] = rng.integers(0, 2, shape)
    if L.hybrid_momentum:
        u[L.UMR:L.UMP + 1] = rho * rng.uniform(-0.4, 0.4, (3,) + shape)
    if bad_cells:
        u[L.URHO, 5, 6, 7] = 1e-14
        u[L.UEINT, 9, 9, 9] = -1.0
        u[L.UEDEN, 10, 11, 12] = -3.0
    return torch.as_tensor(u, dtype=dtype, device=device)


def _close(got, ref, dtype, what=""):
    tol = TOL[dtype]
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol, msg=what)


def _exact(got, ref, what=""):
    """Bit for bit, NaN where both are NaN."""
    assert len(got) == len(ref)
    for i, (g_, r_) in enumerate(zip(got, ref)):
        same = (g_ == r_) | (torch.isnan(g_) & torch.isnan(r_))
        assert bool(same.all()), f"{what} output {i}: {int((~same).sum())} elements differ"


def _flat(o):
    return [o] if isinstance(o, torch.Tensor) else [x for i in o for x in _flat(i)]


def _masks(bc):
    return _bnd_masks(SHAPE, 3, NG, (bc,) * 3, (bc,) * 3)


@DTYPES
@CASES
def test_cell_kernels(card, dtype, layout):
    """prim_aux (all four variants), flatten and clean_fill with status."""
    L = _layout(layout)
    eos = _eos(L)
    u = _state(L, 0, dtype, card, bad_cells=True)
    u = K.clean_fill_plain(u, L, eos, (2,) * 3, (2,) * 3, NG, SMALL["small_dens"],
                           SMALL["small_temp"], 1e-4, True)
    args = (u, L, eos, SMALL["small_dens"], SMALL["small_temp"], DX)
    for with_divu, courant_dt in ((True, DT), (False, DT), (True, None), (False, None)):
        got = K.prim_aux(*args, with_divu=with_divu, courant_dt=courant_dt)
        ref = K.prim_aux_plain(*args, with_divu=with_divu, courant_dt=courant_dt)
        for i, (g_, r_) in enumerate(zip(got, ref)):
            _close(g_, r_, dtype, f"prim_aux output {i} (divu {with_divu}, {courant_dt})")
    _exact([K.flatten(ref[0], L)], [uflatten(ref[0], L)], "flatn")
    raw = _state(L, 3, dtype, card, bad_cells=True)
    for lo, hi in (((2, 2, 2), (2, 2, 2)), ((5, 4, 0), (2, 3, 0))):
        cargs = (raw, L, eos, lo, hi, NG, SMALL["small_dens"], SMALL["small_temp"], 1e-4, True)
        got = K.clean_fill(*cargs, with_status=True)
        ref = K.clean_fill_plain(*cargs, with_status=True)
        _close(got[0], ref[0], dtype, f"clean_fill {lo} {hi}")
        _close(got[1], ref[1], dtype, "min rho")
        assert bool(got[2]) == bool(ref[2])


@DTYPES
@CASES
def test_trace_ppm_kernel(card, dtype, layout):
    """The trace alone and with the fused solve (CGF; HLLC with a source
    and walls), in every direction, bit for bit."""
    L = _layout(layout)
    eos = _eos(L)
    u = _state(L, 1, dtype, card)
    q, qaux = ctoprim(u, L, eos, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    src = 0.05 * torch.randn(q.shape, dtype=dtype, device=card,
                             generator=torch.Generator(card).manual_seed(1))
    for solver, s_, bc in ((0, None, 2), (2, src, 3)):
        for d in range(3):
            args = (q, qaux, s_, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                    SMALL["small_pres"], SMALL["small_ener"])
            _exact(K.trace_ppm(*args), K.trace_ppm_plain(*args), f"d={d} trace")
            fr = dict(coord=0, riemann_solver=solver, bnd_mask=_masks(bc)[d])
            _exact(K.trace_ppm(*args, fuse_riemann=fr), K.trace_ppm_plain(*args, fuse_riemann=fr),
                   f"d={d} solver={solver} fused")


@DTYPES
@CASES
def test_ctu_face_kernel(card, dtype, layout):
    """Every variant in every direction, with wall faces, bit for bit."""
    L = _layout(layout)
    eos = _eos(L)
    u = _state(L, 2, dtype, card)
    q, qaux = ctoprim(u, L, eos, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    tr = [K.trace_ppm_plain(q, qaux, None, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                            SMALL["small_pres"], SMALL["small_ener"],
                            fuse_riemann=dict(coord=0, riemann_solver=0))
          for d in range(3)]
    div = K.prim_aux_plain(u, L, eos, SMALL["small_dens"], SMALL["small_temp"], DX)[2]
    for d in range(3):
        t1, t2 = [t for t in range(3) if t != d]

        def term(t, f):
            return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * DT / DX[t]}

        cons = dict(hsrc=0.1 * u, div_node=50.0 * div, u=u, difmag=0.1, dx=DX,
                    finalize_dt=DT if d == 2 else None)
        for terms, kw in (([], {}), ([term(t2, 1 / 3)], {}),
                          ([term(t1, 1 / 3)], dict(terms2=[term(t2, 1 / 3)])),
                          ([term(t1, 0.5), term(t2, 0.5)], {}),
                          ([term(t1, 0.5), term(t2, 0.5)], dict(consup=cons))):
            args = (tr[d][0], tr[d][1], qaux, d, terms, L, 0, 0, SMALL["small_dens"],
                    SMALL["small_pres"], True, False)
            kw = dict(kw, bnd_mask=_masks(3)[d])
            _exact(_flat(K.ctu_face(*args, **kw)), _flat(K.ctu_face_plain(*args, **kw)),
                   f"d={d} {len(terms)} terms {sorted(kw)}")


def _face_inputs(L, dtype, device, shape, seed=5):
    rng = np.random.default_rng(seed)

    def state():
        q = np.zeros((L.NQ,) + shape)
        q[L.QRHO] = rng.uniform(0.5, 1.5, shape)
        q[L.QU:L.QW + 1] = rng.uniform(-0.6, 0.6, (3,) + shape)
        q[L.QPRES] = rng.uniform(0.3, 2.0, shape)
        q[L.QREINT] = q[L.QPRES] / 0.4
        q[L.QGAME], q[L.QTEMP] = 1.4, 1.0
        q[L.QFS:] = rng.uniform(0.0, 1.0, (L.nspec + L.naux,) + shape)
        return torch.as_tensor(q, dtype=dtype, device=device)

    def bundle():
        df = 0.2 * rng.standard_normal((L.NVAR,) + shape)
        df[L.URHO] = rng.uniform(-0.5, 1.2, shape)  # some densities go negative
        df[L.UEDEN] = rng.uniform(-1.0, 4.0, shape)
        return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in
                     (df, 0.1 * rng.standard_normal(shape), 0.3 * rng.standard_normal(shape)))

    aux = [torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype, device=device)
           for lo, hi in ((1.3, 1.7), (1.3, 1.7), (0.5, 1.5), (0.5, 1.5))]
    return state(), state(), aux, bundle(), bundle()


@DTYPES
@CASES
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_pointwise_kernels(card, dtype, layout, dim):
    """cmpflx, trans_apply and trans_cmpflx, bit for bit, on 1D-3D grids,
    without walls (CGF) and with them (HLLC)."""
    L = _layout(layout, dim)
    shape = SHAPE[:dim] if dim > 1 else (SHAPE[2] * 4,)
    qm, qp, aux, bm, bp = _face_inputs(L, dtype, card, shape)
    for solver, bc in ((0, 2), (2, 3)):
        for d in range(dim):
            mask = _bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim)[d]
            args = (qm, qp, *aux, d, L, 0, solver, SMALL["small_dens"], SMALL["small_pres"])
            _exact(K.cmpflx(*args, bnd_mask=mask), K.cmpflx_plain(*args, bnd_mask=mask),
                   f"cmpflx d={d}")
            if dim == 1:
                continue
            targs = (qm, bm[0], bm[1], bm[2], L, SMALL["small_pres"], True, bool(solver))
            _exact([K.trans_apply(*targs)], [K.trans_apply_plain(*targs)], "trans_apply")
            args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux, d, L, 0, solver,
                    SMALL["small_dens"], SMALL["small_pres"], True, False)
            _exact(K.trans_cmpflx(*args, bnd_mask=mask),
                   K.trans_cmpflx_plain(*args, bnd_mask=mask), f"trans_cmpflx d={d}")


@DTYPES
@CASES
def test_consup_kernel(card, dtype, layout):
    """Each direction, accumulating and finalizing, bit for bit."""
    L = _layout(layout)
    eos = _eos(L)
    u = _state(L, 4, dtype, card)
    q, qaux = ctoprim(u, L, eos, SMALL["small_dens"], SMALL["small_temp"])
    div = K.prim_aux_plain(u, L, eos, SMALL["small_dens"], SMALL["small_temp"], DX)[2]
    for d in range(3):
        flux, qe = K.cmpflx_plain(shifted(q, -1, 1 + d), q, shifted(qaux[L.QGAMC], -1, d),
                                  qaux[L.QGAMC], shifted(qaux[L.QC], -1, d), qaux[L.QC], d, L,
                                  0, 0, SMALL["small_dens"], SMALL["small_pres"])
        args = (0.1 * u, flux, qe[L.GDPRES], qe[L.GDU + d], 50.0 * div, u, d, L, 0.1, DX)
        for fin in (None, DT):
            _exact(K.consup(*args, finalize_dt=fin), K.consup_plain(*args, finalize_dt=fin),
                   f"consup d={d} fin={fin}")


# consup's march (d = 0, 1: a thread a column, segments of cells along d)
# and its rows (d = 2: 31 cells a warp over the flattened grid) on extents
# that are no multiple of a block's 256 columns, a segment or a warp's 31
# cells
@DTYPES
@pytest.mark.parametrize("layout", [(1, 0, False, False)] + LAYOUTS[:1] + LAYOUTS[2:4],
                         ids=["npass1", "iso7", "aprox19", "iso7-shock"])
@pytest.mark.parametrize("shape", [(37, 29, 23), (5, 3, 70)], ids=["37x29x23", "5x3x70"])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_consup_kernel_ragged(card, dtype, layout, shape, d):
    """Accumulating and finalizing, bit for bit."""
    L = _layout(layout)
    eos = _eos(L)
    u = _state(L, 5, dtype, card, shape=shape)
    q, qaux = ctoprim(u, L, eos, SMALL["small_dens"], SMALL["small_temp"])
    div = K.prim_aux_plain(u, L, eos, SMALL["small_dens"], SMALL["small_temp"], DX)[2]
    flux, qe = K.cmpflx_plain(shifted(q, -1, 1 + d), q, shifted(qaux[L.QGAMC], -1, d),
                              qaux[L.QGAMC], shifted(qaux[L.QC], -1, d), qaux[L.QC], d, L, 0, 0,
                              SMALL["small_dens"], SMALL["small_pres"])
    # the solve gives the extras (shock flag, hybrid momenta) no flux; give
    # them one, which takes the viscosity (the shock flag's passes through)
    flux[L.UTEMP + 1:L.UFS] = 0.5 * u[L.UTEMP + 1:L.UFS] + 0.25
    args = (0.1 * u, flux, qe[L.GDPRES], qe[L.GDU + d], 50.0 * div, u, d, L, 0.1, DX)
    for fin in (None, DT):
        before = K.consup.launches
        _exact(K.consup(*args, finalize_dt=fin), K.consup_plain(*args, finalize_dt=fin),
               f"consup d={d} fin={fin}")
        assert K.consup.launches == before + 1


def test_term_bundle_matches_plain_shapes(card):
    """The passive share of a bundle is formed per component: a check that
    the plain bundle carries every passive row the kernels read."""
    L = _layout((7, 1, True, True))
    g = (6, 6, 6)
    r = lambda nc=None: torch.rand(((nc,) if nc else ()) + g, device=card) + 0.5
    term = [{"flux": r(L.NVAR), "qe": r(L.NGDNV), "t_dir": 1, "cdtdx": 0.01}]
    df, dre, dp = term_bundle(term, r(L.NQAUX), 0, 0, L)
    assert df.shape == (L.NVAR,) + g and dre.shape == g and dp.shape == g
