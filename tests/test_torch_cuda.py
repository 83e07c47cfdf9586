"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present (the decision is made there, never at import). On the card:
`python -m pytest -m cuda tests/test_torch_cuda.py`.

Inputs are random states from a seed on a grown grid that is not a cube
(so that an axis mix-up shows; the pointwise kernels also on 1D and 2D
grids), compared in float64 with rtol = atol =
1e-9 (the kernel repeats the plain arithmetic without FMA contraction;
what differs is round-off) and in float32 with rtol = atol = 2e-5 (the
budget of tests/test_pallas.py:41). The tiled kernels trace_ppm, ctu_face
and flatten do their plain versions' operations in the same order and
are held bit for bit, in every direction, on grids whose extents cut
their tiles raggedly: prime extents, an axis of one interior cell
between its ghosts, and (prim_aux and flatten) a grid thinner than a
tile along every axis. The kernels an AMR window runs are also held on
two window shapes: 48 x 32 x 64 interior cells (multiples of the windows'
16-cell bucket) and 36 x 44 x 28 (a window clamped to a level's extent,
not a multiple of 16), each grown by 2 x 4 ghost cells.
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
SHAPE = (20, 24, 28)  # grown extents
# grown extents for the tiled face kernels: SHAPE, prime extents, and one
# interior cell along z
# grown AMR window shapes (driver/amr.py buckets windows to 16 fine cells)
WINDOWS = [(56, 40, 72), (44, 52, 36)]
WINDOW_IDS = ["window-56x40x72", "window-44x52x36"]
FACE_SHAPES = pytest.mark.parametrize("shape", [SHAPE, (37, 29, 45), (28, 20, 2 * NG + 1)]
                                      + WINDOWS, ids=["20x24x28", "37x29x45", "28x20x9"]
                                      + WINDOW_IDS)
DX = (1.0 / 12, 1.0 / 16, 1.0 / 20)
DT = 2e-3
SMALL = dict(small_dens=1e-12, small_temp=1e-12, small_pres=1e-20, small_ener=1e-200)
L = StateLayout(dim=3, nspec=1)
EOS = GammaLawEos(1.4, network=GeneralNullNetwork())
TOL = {torch.float64: 1e-9, torch.float32: 2e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _state(seed, dtype, device, bad_cells=False, shape=SHAPE):
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
    u[L.UFS] = rho
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
    for i, (g_, r_) in enumerate(zip(got, ref)):
        same = (g_ == r_) | (torch.isnan(g_) & torch.isnan(r_))
        assert bool(same.all()), f"{what} output {i}: {int((~same).sum())} elements differ"


def _masks(bc, shape=SHAPE):
    return _bnd_masks(shape, 3, NG, (bc,) * 3, (bc,) * 3)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["f32", "f64"])


def _edge_shock_state(seed, dtype, device, shape, at):
    """_state with a sharp shock at the low edge of every axis: the cells at
    index `at` along axis a keep 1/50 of their internal energy and move
    along a at 0.8, into the grid from index 0 or toward the wall from the
    first interior cell, so that flattening is full at cells whose upwind
    neighbour along a lies beyond the grid's edge or across the wall."""
    u = _state(seed, dtype, device, shape=shape)
    rho = u[L.URHO]
    for a in range(3):
        cut = tuple(slice(at, at + 1) if b == a else slice(None) for b in range(3))
        u[L.UEINT][cut] *= 0.02
        u[L.UMX + a][cut] = (-0.8 if at > 0 else 0.8) * rho[cut]
        mom = u[L.UMX:L.UMZ + 1][(slice(None),) + cut]
        u[L.UEDEN][cut] = u[L.UEINT][cut] + 0.5 * (mom ** 2).sum(0) / rho[cut]
    return u


# the cell kernels' 2.5D tiles: the face kernels' grids, with and without
# walls, and a grid thinner than a tile and a chunk of planes along every
# axis (too thin for ghost cells)
CELL_CASES = pytest.mark.parametrize(
    "shape,walls",
    [(SHAPE, False), (SHAPE, True), ((37, 29, 45), False), ((37, 29, 45), True),
     ((28, 20, 2 * NG + 1), False), ((28, 20, 2 * NG + 1), True), ((9, 5, 3), False),
     (WINDOWS[0], False), (WINDOWS[1], True)],
    ids=["20x24x28", "20x24x28-walls", "37x29x45", "37x29x45-walls", "28x20x9",
         "28x20x9-walls", "9x5x3"] + [WINDOW_IDS[0], WINDOW_IDS[1] + "-walls"])


@DTYPES
@CELL_CASES
def test_prim_aux_and_flatten_kernels(card, dtype, shape, walls):
    """prim_aux in its four variants (div u and the Courant maximum each on
    or off) and flatten (bit for bit) on a state shocked at the low edges;
    with walls, the shock sits in the first interior cells and the ghost
    cells are filled as symmetry walls (lo_bc = hi_bc = 3)."""
    u = _edge_shock_state(0, dtype, card, shape, NG if walls else 0)
    if walls:
        u = K.clean_fill_plain(u, L, EOS, (3,) * 3, (3,) * 3, NG, SMALL["small_dens"],
                               SMALL["small_temp"], 1e-4, True)
    args = (u, L, EOS, SMALL["small_dens"], SMALL["small_temp"], DX)
    for with_divu, courant_dt in ((True, DT), (False, DT), (True, None), (False, None)):
        before = K.prim_aux.launches
        got = K.prim_aux(*args, with_divu=with_divu, courant_dt=courant_dt)
        ref = K.prim_aux_plain(*args, with_divu=with_divu, courant_dt=courant_dt)
        assert K.prim_aux.launches == before + 1
        assert len(got) == len(ref) == 2 + with_divu + (courant_dt is not None)
        for name, g_, r_ in zip(("q", "qaux", "div" if with_divu else "courant", "courant"),
                                got, ref):
            _close(g_, r_, dtype, f"{name} (divu {with_divu}, courant {courant_dt})")
    q = ref[0]
    flatn = uflatten(q, L)
    edge = NG if walls else 0
    assert all(bool((flatn.narrow(a, edge, 1) == 0).any()) for a in range(3))
    before = K.flatten.launches
    _exact([K.flatten(q, L)], [flatn], "flatn")
    assert K.flatten.launches == before + 1


@DTYPES
@FACE_SHAPES
@pytest.mark.parametrize("solver,with_src,bc", [(0, False, 2), (2, True, 3)],
                         ids=["cgf", "hllc-src-wall"])
def test_trace_ppm_kernel(card, dtype, shape, solver, with_src, bc):
    """The trace with the fused solve; bc 3 puts wall faces at both ends of
    every axis."""
    u = _state(1, dtype, card, shape=shape)
    q, qaux = ctoprim(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    src = 0.05 * torch.randn(q.shape, dtype=dtype, device=card,
                             generator=torch.Generator(card).manual_seed(1)) if with_src else None
    for d in range(3):
        fr = dict(coord=0, riemann_solver=solver, bnd_mask=_masks(bc, shape)[d])
        args = (q, qaux, src, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                SMALL["small_pres"], SMALL["small_ener"])
        before = K.trace_ppm.launches
        got = K.trace_ppm(*args, fuse_riemann=fr)
        assert K.trace_ppm.launches == before + 1
        _exact(got, K.trace_ppm_plain(*args, fuse_riemann=fr), f"d={d} (qm, qp, flux, qe)")


@DTYPES
@FACE_SHAPES
@pytest.mark.parametrize("case", ["no-terms", "corner", "pair", "final", "final-consup-fin"])
def test_ctu_face_kernel(card, dtype, shape, case):
    """Every variant in every direction (one corner term along either
    transverse axis), without wall faces and with them at both ends."""
    u = _state(2, dtype, card, shape=shape)
    q, qaux = ctoprim(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    tr = [K.trace_ppm_plain(q, qaux, None, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                            SMALL["small_pres"], SMALL["small_ener"],
                            fuse_riemann=dict(coord=0, riemann_solver=0))
          for d in range(3)]
    div = K.prim_aux_plain(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"], DX)[2]
    flat = lambda o: [o] if isinstance(o, torch.Tensor) else [x for i in o for x in flat(i)]
    for bc, d in [(bc, d) for bc in (2, 3) for d in range(3)]:
        t1, t2 = [t for t in range(3) if t != d]

        def term(t, f):
            return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * DT / DX[t]}

        kw = dict(bnd_mask=_masks(bc, shape)[d])
        stages = [[]]
        if case == "corner":
            stages = [[term(t1, 1 / 3)], [term(t2, 1 / 3)]]
        elif case == "pair":
            stages, kw["terms2"] = [[term(t1, 1 / 3)]], [term(t2, 1 / 3)]
        elif case.startswith("final"):
            stages = [[term(t1, 0.5), term(t2, 0.5)]]
        if "consup" in case:
            kw["consup"] = dict(hsrc=0.1 * u, div_node=div, u=u, difmag=0.1, dx=DX,
                                finalize_dt=DT if d == 2 else None)
        for terms in stages:
            args = (tr[d][0], tr[d][1], qaux, d, terms, L, 0, 0, SMALL["small_dens"],
                    SMALL["small_pres"], True, False)
            before = K.ctu_face.launches
            got = K.ctu_face(*args, **kw)
            assert K.ctu_face.launches == before + 1
            _exact(flat(got), flat(K.ctu_face_plain(*args, **kw)),
                   f"bc={bc} d={d} terms along {[t['t_dir'] for t in terms]}")


@DTYPES
@pytest.mark.parametrize("lo,hi", [((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (3, 3, 3)),
                                   ((0, 0, 0), (0, 0, 0)), ((5, 4, 0), (2, 3, 0))],
                         ids=["outflow", "symmetry", "periodic", "mixed-walls"])
def test_clean_fill_kernel(card, dtype, lo, hi):
    u = _state(3, dtype, card, bad_cells=True)
    args = (u, L, EOS, lo, hi, NG, SMALL["small_dens"], SMALL["small_temp"], 1e-4, True)
    got = K.clean_fill(*args, with_status=True)
    ref = K.clean_fill_plain(*args, with_status=True)
    _close(got[0], ref[0], dtype, "state")
    _close(got[1], ref[1], dtype, "min rho")
    assert bool(got[2]) == bool(ref[2])
    u[L.UMY, 8, 8, 8] = float("nan")
    assert bool(K.clean_fill(*args, with_status=True)[2])


@DTYPES
@pytest.mark.parametrize("shape", WINDOWS, ids=WINDOW_IDS)
@pytest.mark.parametrize("lo,hi", [((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (3, 3, 3))],
                         ids=["outflow", "symmetry"])
def test_clean_fill_kernel_on_windows(card, dtype, shape, lo, hi):
    """As test_clean_fill_kernel, on the grown shapes of AMR windows."""
    u = _state(3, dtype, card, bad_cells=True, shape=shape)
    args = (u, L, EOS, lo, hi, NG, SMALL["small_dens"], SMALL["small_temp"], 1e-4, True)
    before = K.clean_fill.launches
    got = K.clean_fill(*args, with_status=True)
    assert K.clean_fill.launches == before + 1
    ref = K.clean_fill_plain(*args, with_status=True)
    _close(got[0], ref[0], dtype, "state")
    _close(got[1], ref[1], dtype, "min rho")
    assert bool(got[2]) == bool(ref[2])
    _close(K.clean_fill(*args), K.clean_fill_plain(*args), dtype, "no status")


@DTYPES
@FACE_SHAPES
@pytest.mark.parametrize("with_src", [False, True], ids=["no-src", "src"])
def test_trace_ppm_kernel_without_riemann(card, dtype, shape, with_src):
    """The variant the unfused 3D path launches: the trace alone."""
    u = _state(1, dtype, card, shape=shape)
    q, qaux = ctoprim(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    src = 0.05 * torch.randn(q.shape, dtype=dtype, device=card,
                             generator=torch.Generator(card).manual_seed(2)) if with_src else None
    for d in range(3):
        args = (q, qaux, src, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                SMALL["small_pres"], SMALL["small_ener"])
        got, ref = K.trace_ppm(*args), K.trace_ppm_plain(*args)
        assert len(got) == len(ref) == 2
        _exact(got, ref, f"d={d} (qm, qp)")


def _face_inputs(dim, dtype, device, seed=5, shape=None):
    """Face states, both sides' gamc and c, and two summed bundles on a
    `dim`-D grid (default: from SHAPE), from a traced random state."""
    if shape is None:
        shape = SHAPE[:dim] if dim > 1 else (SHAPE[2] * 4,)
    lay = StateLayout(dim=dim, nspec=1)
    rng = np.random.default_rng(seed)

    def state():
        q = np.zeros((lay.NQ,) + shape)
        q[lay.QRHO] = rng.uniform(0.5, 1.5, shape)
        q[lay.QU:lay.QW + 1] = rng.uniform(-0.6, 0.6, (3,) + shape)
        q[lay.QPRES] = rng.uniform(0.3, 2.0, shape)
        q[lay.QREINT] = q[lay.QPRES] / 0.4
        q[lay.QGAME], q[lay.QTEMP] = 1.4, 1.0
        q[lay.QFS] = rng.uniform(0.0, 1.0, shape)
        return torch.as_tensor(q, dtype=dtype, device=device)

    def bundle():
        df = 0.2 * rng.standard_normal((lay.NVAR,) + shape)
        df[lay.URHO] = rng.uniform(-0.5, 1.2, shape)  # some densities go negative
        df[lay.UEDEN] = rng.uniform(-1.0, 4.0, shape)
        return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in
                     (df, 0.1 * rng.standard_normal(shape), 0.3 * rng.standard_normal(shape)))

    aux = [torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype, device=device)
           for lo, hi in ((1.3, 1.7), (1.3, 1.7), (0.5, 1.5), (0.5, 1.5))]
    return lay, shape, state(), state(), aux, bundle(), bundle()


def test_new_entry_points_at_a_tiny_size(card):
    """Each new C entry point called once on a 6^3 grid (and cmpflx on 1D and
    2D grids): a wrong ctypes signature faults here, before any larger test."""
    g = (6, 6, 6)
    z = lambda nc=None: torch.rand(((nc,) if nc else ()) + g, device=card) + 0.5
    flux, qe = K.cmpflx(z(L.NQ), z(L.NQ), z(), z(), z(), z(), 0, L, 0, 0, 1e-12, 1e-20)
    out = K.trans_apply(z(L.NQ), 0.01 * z(L.NVAR), 0.01 * z(), 0.01 * z(), L, 1e-20, True, False)
    f2, _ = K.trans_cmpflx(z(L.NQ), z(L.NQ), 0.01 * z(L.NVAR), 0.01 * z(L.NVAR), 0.01 * z(),
                           0.01 * z(), 0.01 * z(), 0.01 * z(), z(), z(), z(), z(), 1, L, 0, 2,
                           1e-12, 1e-20, True, False)
    h, fc = K.consup(z(L.NVAR), flux, qe[L.GDPRES], qe[L.GDU], z(), z(L.NVAR), 0, L, 0.1,
                     (0.1, 0.1, 0.1), finalize_dt=1e-3)
    for lay, shp in ((StateLayout(dim=1, nspec=1), (7,)), (StateLayout(dim=2, nspec=1), (5, 7))):
        r = lambda nc=None: torch.rand(((nc,) if nc else ()) + shp, device=card) + 0.5
        f1, _ = K.cmpflx(r(lay.NQ), r(lay.NQ), r(), r(), r(), r(), len(shp) - 1, lay, 0, 0,
                         1e-12, 1e-20)
        assert f1.shape == (lay.NVAR,) + shp
    torch.cuda.synchronize()
    for t in (flux, qe, out, f2, h, fc):
        assert bool(torch.isfinite(t).all())


@DTYPES
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("solver,bc", [(0, 2), (2, 3)], ids=["cgf", "hllc-wall"])
def test_cmpflx_kernel(card, dtype, dim, solver, bc):
    lay, shape, qm, qp, aux, _, _ = _face_inputs(dim, dtype, card)
    for d in range(dim):
        mask = _bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim)[d]
        args = (qm, qp, *aux, d, lay, 0, solver, SMALL["small_dens"], SMALL["small_pres"])
        before = K.cmpflx.launches
        got = K.cmpflx(*args, bnd_mask=mask)
        assert K.cmpflx.launches == before + 1
        for g_, r_ in zip(got, K.cmpflx_plain(*args, bnd_mask=mask)):
            _close(g_, r_, dtype, f"d={d}")


@DTYPES
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("reset_density,reset_rhoe", [(True, False), (True, True),
                                                       (False, False)])
def test_trans_apply_kernel(card, dtype, dim, reset_density, reset_rhoe):
    lay, _, q, _, _, (df, dre, dp), _ = _face_inputs(dim, dtype, card)
    if not reset_density:
        df[lay.URHO] = torch.clamp(df[lay.URHO], max=0.3)
    args = (q, df, dre, dp, lay, SMALL["small_pres"], reset_density, reset_rhoe)
    before = K.trans_apply.launches
    got = K.trans_apply(*args)
    assert K.trans_apply.launches == before + 1
    _close(got, K.trans_apply_plain(*args), dtype)


@DTYPES
@pytest.mark.parametrize("dim,solver,bc", [(2, 0, 2), (2, 2, 3), (3, 0, 3)])
def test_trans_cmpflx_kernel(card, dtype, dim, solver, bc):
    lay, shape, qm, qp, aux, bm, bp = _face_inputs(dim, dtype, card)
    for d in range(dim):
        mask = _bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim)[d]
        args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux, d, lay, 0, solver,
                SMALL["small_dens"], SMALL["small_pres"], True, False)
        got = K.trans_cmpflx(*args, bnd_mask=mask)
        ref = K.trans_cmpflx_plain(*args, bnd_mask=mask)
        # a face whose corrected (rho e) cancels to nothing amplifies a rounding
        ok = ref[1][lay.GDGAME] < 11.0
        assert float(ok.double().mean()) > 0.7
        for g_, r_ in zip(got, ref):
            _close(g_[:, ok], r_[:, ok], dtype, f"d={d}")


@DTYPES
@pytest.mark.parametrize("d", [0, 1, 2])
@pytest.mark.parametrize("with_fin", [False, True], ids=["hsrc", "finalize"])
def test_consup_kernel(card, dtype, d, with_fin):
    u = _state(4, dtype, card)
    q, qaux = ctoprim(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"])
    div = K.prim_aux_plain(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"], DX)[2]
    flux, qe = K.cmpflx_plain(shifted(q, -1, 1 + d), q, shifted(qaux[L.QGAMC], -1, d),
                              qaux[L.QGAMC], shifted(qaux[L.QC], -1, d), qaux[L.QC], d, L, 0,
                              0, SMALL["small_dens"], SMALL["small_pres"])
    args = (0.1 * u, flux, qe[L.GDPRES], qe[L.GDU + d], 50.0 * div, u, d, L, 0.1, DX)
    fin = DT if with_fin else None
    before = K.consup.launches
    got = K.consup(*args, finalize_dt=fin)
    assert K.consup.launches == before + 1
    for name, g_, r_ in zip(("hsrc", "flux"), got, K.consup_plain(*args, finalize_dt=fin)):
        _close(g_, r_, dtype, name)


@DTYPES
@pytest.mark.parametrize("shape", [WINDOWS[0][:2], WINDOWS[1][1:], WINDOWS[0][2:],
                                   WINDOWS[1][:1]],
                         ids=["2D-56x40", "2D-52x36", "1D-72", "1D-44"])
def test_cmpflx_and_trans_cmpflx_kernels_on_windows(card, dtype, shape):
    """cmpflx (1D and 2D) and trans_cmpflx (2D), the kernels of a 1D or 2D
    AMR window's step, on window shapes, with wall faces (HLLC) and
    without (CGF), as test_cmpflx_kernel and test_trans_cmpflx_kernel."""
    dim = len(shape)
    lay, shape, qm, qp, aux, bm, bp = _face_inputs(dim, dtype, card, shape=shape)
    for solver, bc in ((0, 2), (2, 3)):
        for d in range(dim):
            mask = _bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim)[d]
            args = (qm, qp, *aux, d, lay, 0, solver, SMALL["small_dens"], SMALL["small_pres"])
            before = K.cmpflx.launches
            got = K.cmpflx(*args, bnd_mask=mask)
            assert K.cmpflx.launches == before + 1
            for g_, r_ in zip(got, K.cmpflx_plain(*args, bnd_mask=mask)):
                _close(g_, r_, dtype, f"cmpflx d={d}")
            if dim == 1:
                continue
            args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux, d, lay, 0, solver,
                    SMALL["small_dens"], SMALL["small_pres"], True, False)
            got = K.trans_cmpflx(*args, bnd_mask=mask)
            ref = K.trans_cmpflx_plain(*args, bnd_mask=mask)
            ok = ref[1][lay.GDGAME] < 11.0  # as test_trans_cmpflx_kernel
            assert float(ok.double().mean()) > 0.7
            for g_, r_ in zip(got, ref):
                _close(g_[:, ok], r_[:, ok], dtype, f"trans_cmpflx d={d}")


def test_term_bundle_feeds_trans_apply_as_ctu_face(card):
    """trans_apply on the torch-op bundle, then cmpflx, equals the fused
    ctu_face corner stage (float64)."""
    dtype = torch.float64
    u = _state(2, dtype, card)
    q, qaux = ctoprim(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    tr = [K.trace_ppm_plain(q, qaux, None, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                            SMALL["small_pres"], SMALL["small_ener"],
                            fuse_riemann=dict(coord=0, riemann_solver=0)) for d in range(3)]
    n, t = 0, 2
    term = [{"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": DT / 3 / DX[t]}]
    qs = []
    for q_face, shift in ((tr[n][0], -1), (tr[n][1], 0)):
        df, dre, dp = term_bundle(term, qaux, n, shift, L)
        qs.append(K.trans_apply(q_face, df, dre, dp, L, SMALL["small_pres"], True, False))
    g, c = qaux[L.QGAMC], qaux[L.QC]
    got = K.cmpflx(qs[0], qs[1], shifted(g, -1, n), g, shifted(c, -1, n), c, n, L, 0, 0,
                   SMALL["small_dens"], SMALL["small_pres"])
    ref = K.ctu_face(tr[n][0], tr[n][1], qaux, n, term, L, 0, 0, SMALL["small_dens"],
                     SMALL["small_pres"], True, False)
    for g_, r_ in zip(got, ref):
        _close(g_, r_, dtype)


def test_wrappers_refuse_bad_inputs(card):
    u = _state(0, torch.float32, card)
    with pytest.raises(TypeError):
        K.flatten(torch.zeros((L.NQ,) + SHAPE, dtype=torch.float16, device=card), L)
    with pytest.raises(ValueError):
        K.prim_aux(u[:, :, :, ::2], L, EOS, 1e-12, 1e-12, DX)
    mhd = StateLayout(dim=3, nspec=1, mhd=True)  # the kernels carry no magnetic fields
    with pytest.raises(NotImplementedError):
        K.prim_aux(torch.zeros((mhd.NVAR,) + SHAPE, device=card), mhd, EOS, 1e-12, 1e-12, DX)
    lay2 = StateLayout(dim=2, nspec=1)
    z2 = torch.ones((lay2.NVAR, 8, 8), device=card)
    with pytest.raises(NotImplementedError, match="3D"):  # consup is 3D only
        K.consup(z2, z2, z2[0], z2[0], z2[0], z2, 0, lay2, 0.1, (0.1, 0.1))
    q2 = torch.ones((lay2.NQ, 8, 8), device=card)
    with pytest.raises(NotImplementedError, match="riemann_solver=1"):
        K.cmpflx(q2, q2, q2[0], q2[0], q2[0], q2[0], 0, lay2, 0, 1, 1e-12, 1e-20)
    with pytest.raises(ValueError, match="dflux"):
        K.trans_apply(q2, z2[:, :4], q2[0], q2[0], lay2, 1e-20, True, False)
    # the face kernel fixes the terms' directions with the normal's
    q3 = torch.ones((L.NQ,) + SHAPE, device=card)
    term = {"flux": u, "qe": torch.ones((L.NGDNV,) + SHAPE, device=card), "cdtdx": 0.1}
    with pytest.raises(ValueError, match="takes terms along 1 then 2"):
        K.ctu_face(q3, q3, q3[:L.NQAUX], 0, [dict(term, t_dir=2), dict(term, t_dir=1)], L, 0,
                   0, 1e-12, 1e-20, True, False)


@pytest.mark.parametrize("dim,castro", [
    (3, dict(riemann_solver=1)), (3, dict(hybrid_riemann=1)), (2, dict()),
    (2, dict(lo_bc=(3, 3, 3), hi_bc=(3, 3, 3), riemann_solver=2)),
    (2, dict(riemann_solver=1)), (1, dict())],
    ids=["3d-cg", "3d-hybrid", "2d", "2d-symmetry-hllc", "2d-cg", "1d"])
def test_unfused_paths_card_vs_cpu(card, dim, castro):
    """Three steps of each new path on the card against the CPU (float64)."""
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import sedov

    params = sedov.make_params(n=16 if dim == 3 else 32, dim=dim, r_init=0.2, dtype="float64")
    params = params.with_ns("castro", **castro) if castro else params
    out = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(params, problem_init=sedov.problem_init, device=dev)
        sim.init_data()
        for _ in range(3):
            sim.advance(2e-3)
        out[dev] = sim.interior().cpu()
    _close(out["cuda"], out["cpu"], torch.float64, "state after 3 steps")


@pytest.mark.parametrize("bc", [2, 3, 0], ids=["outflow", "symmetry", "periodic"])
def test_sedov_step_card_vs_cpu(card, bc):
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import sedov

    params = sedov.make_params(n=16, dim=3, r_init=0.2, dtype="float64")
    params = params.with_ns("castro", lo_bc=(bc,) * 3, hi_bc=(bc,) * 3)
    out = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(params, problem_init=sedov.problem_init, device=dev)
        sim.init_data()
        for _ in range(3):
            sim.advance(2e-3)
        out[dev] = sim.interior().cpu()
    _close(out["cuda"], out["cpu"], torch.float64, "state after 3 steps")


@DTYPES
@pytest.mark.parametrize("dim,coord", [(1, 1), (1, 2), (2, 1)],
                         ids=["1d-cylindrical", "1d-spherical", "2d-rz"])
def test_cmpflx_and_trans_cmpflx_kernels_with_coord(card, dtype, dim, coord):
    """coord 1 and 2 drop the pressure from the radial momentum flux, the
    wall face on the axis included."""
    lay, shape, qm, qp, aux, bm, bp = _face_inputs(dim, dtype, card, seed=11)
    for d in range(dim):
        mask = _bnd_masks(shape, dim, NG, (3,) * dim, (2,) * dim)[d]
        args = (qm, qp, *aux, d, lay, coord, 0, SMALL["small_dens"], SMALL["small_pres"])
        got = K.cmpflx(*args, bnd_mask=mask)
        for g_, r_ in zip(got, K.cmpflx_plain(*args, bnd_mask=mask)):
            _close(g_, r_, dtype, f"cmpflx d={d}")
        args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux, d, lay, coord, 0,
                SMALL["small_dens"], SMALL["small_pres"], True, False)
        got = K.trans_cmpflx(*args, bnd_mask=mask)
        ref = K.trans_cmpflx_plain(*args, bnd_mask=mask)
        ok = ref[1][lay.GDGAME] < 11.0
        for g_, r_ in zip(got, ref):
            _close(g_[:, ok], r_[:, ok], dtype, f"trans_cmpflx d={d}")


@DTYPES
def test_probe_cmpflx_and_copy_kernels(card, dtype):
    """Every tiling of the Riemann probe and both copy tilings equal their
    plain versions (float32 bit for bit, as chip_smoke.py holds them)."""
    from castro_tpu_torch.ops import probes as P

    _, shape, qm, qp, aux, _, _ = _face_inputs(3, dtype, card, seed=12)
    ref = P.probe_cmpflx_plain(qm, qp, *aux, L, 0, SMALL["small_dens"], SMALL["small_pres"])
    tiles = list(P.TPU_TILINGS.values()) + [P.BEST_TILE, (3, 5)]
    for tile in tiles:
        before = P.probe_cmpflx.launches
        got = P.probe_cmpflx(qm, qp, *aux, L, 0, SMALL["small_dens"], SMALL["small_pres"],
                             tile=tile)
        assert P.probe_cmpflx.launches == before + 1
        for g_, r_ in zip(got, ref):
            _close(g_, r_, dtype, f"tile {tile}")
    cref = P.probe_copy_plain(qm, qp, L)
    for tile in ((8, None), P.BEST_TILE):
        for g_, r_ in zip(P.probe_copy(qm, qp, L, tile=tile), cref):
            assert torch.equal(g_, r_)


@pytest.mark.parametrize("op", ["fma", "fma_rn", "div", "rsqrt", "recip_approx", "exp"])
def test_probe_vpu_kernel(card, op):
    """Each body against its plain version at 300 iterations; the rounding
    budgets of chip_smoke.py:VPU_RTOL."""
    from castro_tpu_torch.ops import probes as P

    iters = 300
    rtol = {"fma": 0.0, "div": 0.0, "fma_rn": iters * 2.0 ** -23,
            "recip_approx": 2 * iters * 2.0 ** -23, "rsqrt": 8 * 2.0 ** -23,
            "exp": 8 * 2.0 ** -23}[op]
    x = torch.linspace(0.3, 3.0, 4096, device=card).reshape(64, 64)
    got = P.probe_vpu(x, op, iters)
    ref = P.probe_vpu_plain(x, op, iters)
    torch.testing.assert_close(got, ref, rtol=rtol, atol=0.0)
    with pytest.raises(TypeError):
        P.probe_vpu(x.double(), op, 1)


@pytest.mark.parametrize("op", ["fma", "div"])
@pytest.mark.parametrize("shape,iters", [((333, 271), 137), ((777, 773), 53)],
                         ids=["90243x137", "600621x53"])
def test_probe_vpu_kernel_ragged(card, op, shape, iters):
    """Bit for bit at an element count that is no multiple of the four
    elements a thread carries (the first fills part of one wave, the second
    three), over iteration counts that are no multiple of the unroll
    factors 50 and 10."""
    from castro_tpu_torch.ops import probes as P

    n = shape[0] * shape[1]
    x = torch.linspace(0.3, 3.0, n, device=card).reshape(shape)
    got = P.probe_vpu(x, op, iters)
    assert torch.equal(got, P.probe_vpu_plain(x, op, iters))


@DTYPES
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_multigrid_card_vs_cpu(card, dtype, bc):
    """The multigrid's V-cycles in torch ops on the card against the CPU: a
    Dirichlet problem with face values and the singular periodic one (its
    pinned dense bottom factored on the card), run to a tolerance; the
    solution within the dtype's tolerance of its largest magnitude, and
    the same V-cycle count (float32 within one: its stalled residual sits
    at the rounding of the sums, which the card orders otherwise)."""
    from castro_tpu_torch.solvers import multigrid as mg

    rng = np.random.default_rng(21)
    rhs = rng.standard_normal((24, 20, 16))
    vals = [rng.standard_normal(s) for s in ((1, 20, 16), (24, 1, 16), (24, 20, 1))]
    out = {}
    for dev in ("cpu", "cuda"):
        kw = dict(bc_lo=(bc,) * 3, bc_hi=(bc,) * 3, n_vcycles=30,
                  rtol=1e-9 if dtype == torch.float64 else 1e-4)
        if bc == "dirichlet":
            kw["bc_vals_lo"] = [torch.as_tensor(v, dtype=dtype, device=dev) for v in vals]
        stats = []
        u, _ = mg.poisson(torch.as_tensor(rhs, dtype=dtype, device=dev), (0.1, 0.12, 0.15),
                          stats=stats, **kw)
        out[dev] = (u.cpu(), stats[0][0])
    u_card, u_cpu = out["cuda"][0], out["cpu"][0]
    err = float((u_card - u_cpu).abs().max() / u_cpu.abs().max())
    assert err <= TOL[dtype], err
    slack = 0 if dtype == torch.float64 else 1
    assert abs(out["cuda"][1] - out["cpu"][1]) <= slack, (out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("gtype", ["PoissonGrav", "MonopoleGrav"])
def test_gravity_step_card_vs_cpu(card, gtype):
    """Two steps of the 3D DustCollapse (float64, 16^3, the fixed dt of
    chip_smoke.py's path I) on the card against the CPU: 1e-8 |cpu| + 1e-8
    max|cpu| per component, rho e and rho T with their floor scaled by
    max|rho E| / max|rho e| (e is E - KE in the cold collapse); two
    gravity fields a step on both."""
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import dust_collapse

    params = dust_collapse.make_params(n=16, dim=3, dtype="float64").with_ns(
        "gravity", gravity_type=gtype)
    out = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(params, problem_init=dust_collapse.problem_init, device=dev)
        sim.init_data()
        for _ in range(2):
            sim.advance(2e-5)
        out[dev] = sim.interior().cpu()
        if gtype == "PoissonGrav":
            assert len(sim.source_fns[0].gravity.solve_stats) == 4
    Ls, rtol = sim.layout, 1e-8
    got, ref = out["cuda"], out["cpu"]
    mag = ref.abs().flatten(1).amax(1)
    ratio = float(mag[Ls.UEDEN] / mag[Ls.UEINT])
    for c in range(Ls.NVAR):
        g_, r_, m_ = got[c], ref[c], float(mag[c])
        if c in (Ls.UEINT, Ls.UTEMP):
            g_, r_ = g_ * got[Ls.URHO], r_ * ref[Ls.URHO]
            m_ = float(r_.abs().max()) * max(ratio, 1.0)
        bad = (g_ - r_).abs() > rtol * r_.abs() + rtol * m_
        assert not bool(bad.any()), (c, int(bad.sum()))
