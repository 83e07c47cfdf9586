"""The plain PyTorch versions of the cmpflx, trans_apply, trans_cmpflx and
consup kernels against the JAX Pallas kernel functions on the same inputs
(float32, small grids that are not cubes so that an axis mix-up shows).

The JAX side runs its Pallas kernels through the interpreter
(`pallas_kernels.INTERPRET = True`, restored in `finally`, as
tests/test_pallas.py does). Inputs are made from a seed with numpy and
handed to both packages as numpy arrays. The wall-mask variant of cmpflx,
which the JAX package leaves to its XLA path, is held against that path.

Tolerance: rtol = atol = 2e-5, the fused-vs-XLA float32 budget the JAX
package already accepts (tests/test_pallas.py:41).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.ops import ctu as jctu
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.state import StateLayout as JLayout

from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.ctu import _bnd_masks
from castro_tpu_torch.state import StateLayout

RTOL = ATOL = 2e-5
NG = 4
SHAPES = {1: (40,), 2: (16, 24), 3: (12, 16, 20)}
SMALL_DENS, SMALL_PRES = 1e-12, 1e-20


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _interpret(fn, *a, **kw):
    pk.INTERPRET = True
    try:
        return jax.tree_util.tree_map(np.asarray, fn(*a, **kw))
    finally:
        pk.INTERPRET = False


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, what=""):
    assert len(got) == len(ref)
    for i, (g_, r_) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} output {i}")


def _layouts(dim):
    return JLayout(dim=dim, nspec=1), StateLayout(dim=dim, nspec=1)


def _face_states(dim, seed):
    """Random interface states qm, qp [NQ] with strong jumps, and the gamc
    and c of the cells on both sides."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[dim]
    L = StateLayout(dim=dim, nspec=1)

    def state():
        q = np.zeros((L.NQ,) + shape)
        q[L.QRHO] = rng.uniform(0.5, 1.5, shape)
        q[L.QU:L.QW + 1] = rng.uniform(-0.6, 0.6, (3,) + shape)
        q[L.QPRES] = rng.uniform(0.3, 2.0, shape)
        q[L.QREINT] = q[L.QPRES] / 0.4
        q[L.QGAME] = 1.4
        q[L.QTEMP] = 1.0
        q[L.QFS] = rng.uniform(0.0, 1.0, shape)
        return q.astype(np.float32)

    aux = [rng.uniform(lo, hi, shape).astype(np.float32)
           for lo, hi in ((1.3, 1.7), (1.3, 1.7), (0.5, 1.5), (0.5, 1.5))]
    return state(), state(), aux


def _bundle(dim, seed):
    """A random summed transverse bundle (dflux [NVAR], dre, dp) large enough
    to drive some densities and internal energies negative."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[dim]
    L = StateLayout(dim=dim, nspec=1)
    df = (0.2 * rng.standard_normal((L.NVAR,) + shape)).astype(np.float32)
    df[L.URHO] = rng.uniform(-0.5, 1.2, shape)
    df[L.UEDEN] = rng.uniform(-1.0, 4.0, shape)
    dre = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    dp = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    return df, dre, dp


@pytest.mark.parametrize("solver", [0, 2], ids=["cgf", "hllc"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_cmpflx_plain_vs_pallas(dim, solver):
    JL, TL = _layouts(dim)
    qm, qp, aux = _face_states(dim, seed=dim)
    for d in range(dim):
        ref = _interpret(pk.cmpflx_pallas, jnp.asarray(qm), jnp.asarray(qp),
                         *(jnp.asarray(a) for a in aux), d, JL, 0, solver, SMALL_DENS,
                         SMALL_PRES)
        got = K.cmpflx(_t(qm), _t(qp), *(_t(a) for a in aux), d, TL, 0, solver, SMALL_DENS,
                       SMALL_PRES)
        _close(got, ref, f"d={d}")
    assert K.cmpflx.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_cmpflx_plain_wall_mask_vs_jax(dim):
    """With wall faces the port stays on cmpflx; the JAX package computes
    the same through `compute_flux(..., bnd_mask=...)`."""
    JL, TL = _layouts(dim)
    shape = SHAPES[dim]
    qm, qp, aux = _face_states(dim, seed=10 + dim)
    d = dim - 1
    jmask = jctu._bnd_masks(shape, dim, NG, (3,) * dim, (4,) * dim, jnp.float32,
                            (None,) * dim)[d]
    tmask = _bnd_masks(shape, dim, NG, (3,) * dim, (4,) * dim)[d]
    ref = pk._riemann_block(jnp.asarray(qm), jnp.asarray(qp), *(jnp.asarray(a) for a in aux),
                            d, JL, 0, 0, SMALL_DENS, SMALL_PRES, bnd_mask=jmask)
    got = K.cmpflx(_t(qm), _t(qp), *(_t(a) for a in aux), d, TL, 0, 0, SMALL_DENS,
                   SMALL_PRES, bnd_mask=tmask)
    _close(got, ref)
    idx = [slice(None)] * dim
    idx[d] = NG
    assert not got[1][(TL.GDU + d,) + tuple(idx)].any()  # zero velocity on the wall


@pytest.mark.parametrize("reset_density,reset_rhoe", [(True, False), (True, True),
                                                       (False, True), (False, False)])
@pytest.mark.parametrize("dim", [2, 3])
def test_trans_apply_plain_vs_pallas(dim, reset_density, reset_rhoe):
    JL, TL = _layouts(dim)
    q, _, _ = _face_states(dim, seed=20 + dim)
    df, dre, dp = _bundle(dim, seed=30 + dim)
    if not reset_density:
        df[TL.URHO] = np.minimum(df[TL.URHO], 0.3)  # keep the density positive
    ref = _interpret(pk.trans_apply_pallas, *(jnp.asarray(a) for a in (q, df, dre, dp)), JL,
                     SMALL_PRES, reset_density, reset_rhoe)
    got = K.trans_apply(*(_t(a) for a in (q, df, dre, dp)), TL, SMALL_PRES, reset_density,
                        reset_rhoe)
    _close([got], [ref])
    if reset_density:
        # some cells do trip the reset and keep their density, (rho e),
        # pressure and species
        tripped = q[TL.QRHO] - df[TL.URHO] < 0.0
        assert tripped.any() and not tripped.all()
        for comp in (TL.QRHO, TL.QREINT, TL.QPRES, TL.QFS):
            np.testing.assert_array_equal(got[comp].numpy()[tripped], q[comp][tripped])
    np.testing.assert_array_equal(got[TL.QTEMP].numpy(), q[TL.QTEMP])  # copied through


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "wall-mask"])
@pytest.mark.parametrize("dim,solver", [(2, 0), (2, 2), (3, 0)])
def test_trans_cmpflx_plain_vs_pallas(dim, solver, with_mask):
    JL, TL = _layouts(dim)
    shape = SHAPES[dim]
    qm, qp, aux = _face_states(dim, seed=40 + dim)
    bm, bp = _bundle(dim, seed=50 + dim), _bundle(dim, seed=60 + dim)
    # Faces whose corrected states keep at least a tenth of their density
    # and internal energy, and whose Godunov (rho e) did not cancel to under
    # a tenth of the pressure, are compared: where these random states
    # cancel to nearly nothing, one rounding is amplified beyond any budget
    # (the resets themselves are held in test_trans_apply_plain_vs_pallas).
    sound = np.ones(shape, bool)
    for q, b in ((qm, bm), (qp, bp)):
        qc = K.trans_apply_plain(*(_t(a) for a in (q, *b)), TL, SMALL_PRES, True, False).numpy()
        sound &= (qc[TL.QRHO] > 0.1 * q[TL.QRHO]) & (qc[TL.QREINT] > 0.1 * q[TL.QREINT])
    assert sound.mean() > 0.7
    args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux)
    for d in range(dim):
        jmask = tmask = None
        if with_mask:
            jmask = jctu._bnd_masks(shape, dim, NG, (3,) * dim, (3,) * dim, jnp.float32,
                                    (None,) * dim)[d]
            tmask = _bnd_masks(shape, dim, NG, (3,) * dim, (3,) * dim)[d]
        ref = _interpret(pk.trans_cmpflx_pallas, *(jnp.asarray(a) for a in args), d, JL, 0,
                         solver, SMALL_DENS, SMALL_PRES, True, False, bnd_mask=jmask)
        got = K.trans_cmpflx(*(_t(a) for a in args), d, TL, 0, solver, SMALL_DENS,
                             SMALL_PRES, True, False, bnd_mask=tmask)
        ok = sound & (ref[1][TL.GDGAME] < 11.0)
        assert ok.mean() > 0.7
        _close([g_[:, ok] for g_ in got], [r_[:, ok] for r_ in ref], f"d={d}")


@pytest.mark.parametrize("with_fin", [False, True], ids=["hsrc", "finalize"])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_consup_plain_vs_pallas(d, with_fin):
    JL, TL = _layouts(3)
    shape = SHAPES[3]
    dx = (1.0 / 4, 1.0 / 8, 1.0 / 12)
    rng = np.random.default_rng(70 + d)
    f32 = np.float32
    hsrc = (0.1 * rng.standard_normal((TL.NVAR,) + shape)).astype(f32)
    flux = rng.standard_normal((TL.NVAR,) + shape).astype(f32)
    flux[TL.UTEMP] = 0.0
    flux[TL.UFS] = flux[TL.URHO] * rng.uniform(0.9, 1.1, shape)
    flux[TL.UFS, 3, 4, 5] = 0.0  # the normalization's zero-sum branch
    u = rng.uniform(0.5, 1.5, (TL.NVAR,) + shape).astype(f32)
    pg = rng.uniform(0.3, 2.0, shape).astype(f32)
    ug = rng.uniform(-0.5, 0.5, shape).astype(f32)
    div = rng.uniform(-3.0, 1.0, shape).astype(f32)  # mostly converging: viscosity on
    fin = f32(2e-3) if with_fin else None
    arrs = (hsrc, flux, pg, ug, div, u)
    ref = _interpret(pk.consup_pallas, *(jnp.asarray(a) for a in arrs), d, JL, 0.1, dx,
                     finalize_dt=fin)
    got = K.consup(*(_t(a) for a in arrs), d, TL, 0.1, dx, finalize_dt=fin)
    _close(got, ref)
    # the temperature row takes no viscosity
    np.testing.assert_array_equal(got[1][TL.UTEMP].numpy(), flux[TL.UTEMP])
    assert K.consup.launches == 0


# (nspec, shock_var): the layouts test_consup_plain_vs_pallas does not
# reach, a species sum over several components and the shock flag, whose
# flux takes no viscosity
@pytest.mark.parametrize("d", [0, 1, 2])
@pytest.mark.parametrize("nspec,shock", [(3, False), (2, True)], ids=["nspec3", "nspec2-shock"])
def test_consup_plain_vs_pallas_layouts(nspec, shock, d):
    JL = JLayout(dim=3, nspec=nspec, shock_var=shock)
    TL = StateLayout(dim=3, nspec=nspec, shock_var=shock)
    shape = SHAPES[3]
    dx = (1.0 / 4, 1.0 / 8, 1.0 / 12)
    rng = np.random.default_rng(80 + 3 * nspec + d)
    f32 = np.float32
    hsrc = (0.1 * rng.standard_normal((TL.NVAR,) + shape)).astype(f32)
    flux = rng.standard_normal((TL.NVAR,) + shape).astype(f32)
    flux[TL.UTEMP] = 0.0
    x = rng.uniform(0.2, 1.0, (nspec,) + shape)
    flux[TL.UFS:TL.UFS + nspec] = flux[TL.URHO] * x / x.sum(0) * rng.uniform(0.9, 1.1, shape)
    flux[TL.UFS:TL.UFS + nspec, 3, 4, 5] = 0.0  # the normalization's zero-sum branch
    u = rng.uniform(0.5, 1.5, (TL.NVAR,) + shape).astype(f32)
    pg = rng.uniform(0.3, 2.0, shape).astype(f32)
    ug = rng.uniform(-0.5, 0.5, shape).astype(f32)
    div = rng.uniform(-3.0, 1.0, shape).astype(f32)
    fin = f32(2e-3) if d == 2 else None  # the unfused step finalizes on its last direction
    arrs = (hsrc, flux, pg, ug, div, u)
    ref = _interpret(pk.consup_pallas, *(jnp.asarray(a) for a in arrs), d, JL, 0.1, dx,
                     finalize_dt=fin)
    got = K.consup(*(_t(a) for a in arrs), d, TL, 0.1, dx, finalize_dt=fin)
    _close(got, ref, f"nspec={nspec} shock={shock} d={d}")
    # the species fluxes sum to the density flux wherever they did not sum to 0
    fl = got[1].numpy()
    ssum = fl[TL.UFS:TL.UFS + nspec].sum(0)
    np.testing.assert_allclose(ssum[ssum != 0.0], fl[TL.URHO][ssum != 0.0], rtol=1e-5, atol=1e-6)
    if shock:  # neither fluxed nor viscous: the flux passes through
        np.testing.assert_array_equal(fl[TL.USHK], flux[TL.USHK])
    assert K.consup.launches == 0
