"""The port's iterative Colella-Glaz solver, HLLE flux, shock detector and
hybrid `cmpflx` against the JAX functions on the same inputs, made from a
seed with numpy (1D, 2D and 3D grids that are not cubes).

Both sides do the same arithmetic op by op on the CPU. Tolerances: float64
rtol = 1e-10 with an absolute floor of 1e-10 times the output's largest
magnitude; float32 rtol = atol = 2e-5 (tests/test_pallas.py:41). The shock
flag is 0 or 1 and must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from castro_tpu.ops import advection_util as jau
from castro_tpu.ops import ctu as jctu
from castro_tpu.ops import riemann as jr
from castro_tpu.state import StateLayout as JLayout

from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import riemann as tr
from castro_tpu_torch.ops.ctu import _bnd_masks
from castro_tpu_torch.state import StateLayout

NG = 4
SHAPES = {1: (48,), 2: (20, 24), 3: (12, 14, 16)}
SMALL_DENS, SMALL_PRES = 1e-12, 1e-20
DTYPES = pytest.mark.parametrize("dtype", ["float64", "float32"])


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, dtype, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, ref = got.astype(np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    if dtype == "float64":
        tol = 1e-10 * np.abs(ref) + 1e-10 * np.abs(ref).max() + 1e-300
        np.testing.assert_array_less(np.abs(got - ref), tol, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5, err_msg=what)


def _prims(dim, seed, dtype, smooth=False):
    """Random primitive cell state q [NQ], qaux [NQAUX] of a gamma = 1.4 gas
    and slightly different face states qm, qp; `smooth` keeps the jumps
    weak enough for riemanncg to converge on most faces."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[dim]
    L = StateLayout(dim=dim, nspec=1)
    amp = 0.1 if smooth else 1.0

    def state():
        q = np.zeros((L.NQ,) + shape)
        q[L.QRHO] = 1.0 + amp * rng.uniform(-0.5, 0.5, shape)
        q[L.QU:L.QW + 1] = amp * rng.uniform(-0.6, 0.6, (3,) + shape)
        q[L.QPRES] = 1.0 + amp * rng.uniform(-0.7, 1.0, shape)
        q[L.QREINT] = q[L.QPRES] / 0.4
        q[L.QGAME] = 1.4
        q[L.QTEMP] = 1.0
        q[L.QFS] = rng.uniform(0.0, 1.0, shape)
        return q.astype(dtype)

    q = state()
    qaux = np.zeros((L.NQAUX,) + shape)
    qaux[L.QGAMC] = 1.4
    qaux[L.QC] = np.sqrt(1.4 * q[L.QPRES] / q[L.QRHO])
    return q, qaux.astype(dtype), state(), state()


def _inputs(dim, d, seed, dtype, smooth=False):
    JL, TL = JLayout(dim=dim, nspec=1), StateLayout(dim=dim, nspec=1)
    q, qaux, qm, qp = _prims(dim, seed, dtype, smooth)
    jri = jr.load_inputs(jnp.asarray(qm), jnp.asarray(qp), jnp.asarray(qaux), d, JL,
                         SMALL_DENS)
    tri = tr.load_inputs(_t(qm), _t(qp), _t(qaux), d, TL, SMALL_DENS)
    return JL, TL, jri, tri, (q, qaux, qm, qp)


@DTYPES
@pytest.mark.parametrize("dim,d,smooth", [(1, 0, True), (2, 1, False), (3, 2, True),
                                          (3, 0, False)])
def test_riemanncg_matches_jax(dim, d, smooth, dtype):
    _, _, jri, tri, _ = _inputs(dim, d, 100 + dim + d, dtype, smooth)
    ref = jr.riemanncg(jri, SMALL_DENS, SMALL_PRES)
    got = tr.riemanncg(tri, SMALL_DENS, SMALL_PRES)
    for name in ("rho", "un", "ut", "utt", "p", "rhoe", "ustar"):
        _close(getattr(got, name), getattr(ref, name), dtype, name)
    # fewer iterations leave faces unconverged: the two-shock fallback
    ref2 = jr.riemanncg(jri, SMALL_DENS, SMALL_PRES, maxiter=2, cg_tol=1e-12)
    got2 = tr.riemanncg(tri, SMALL_DENS, SMALL_PRES, maxiter=2, cg_tol=1e-12)
    _close(got2.p, ref2.p, dtype, "p, fallback")
    _close(got2.rhoe, ref2.rhoe, dtype, "rhoe, fallback")


@DTYPES
@pytest.mark.parametrize("dim,d", [(1, 0), (2, 0), (3, 1)])
def test_hll_flux_matches_jax(dim, d, dtype):
    JL, TL, jri, tri, _ = _inputs(dim, d, 200 + dim, dtype)
    _close(tr.hll_flux(tri, d, TL, SMALL_DENS, SMALL_PRES),
           jr.hll_flux(jri, d, JL, SMALL_DENS, SMALL_PRES), dtype)


@DTYPES
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_shock_matches_jax(dim, dtype):
    JL, TL = JLayout(dim=dim, nspec=1), StateLayout(dim=dim, nspec=1)
    q, _, _, _ = _prims(dim, 300 + dim, dtype)
    dx = (0.1, 0.05, 0.2)[:dim]
    for threshold in (2.0 / 3.0, 0.1):
        ref = np.asarray(jau.shock(jnp.asarray(q), dx, JL, threshold))
        got = au.shock(_t(q), dx, TL, threshold)
        assert got.dtype == _t(q).dtype
        np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < got.sum() < got.numel()  # some zones are flagged, not all


@DTYPES
@pytest.mark.parametrize("dim,d,solver,bc", [(1, 0, 0, 2), (2, 1, 2, 3), (3, 2, 0, 3),
                                             (3, 0, 1, 2)])
def test_cmpflx_hybrid_matches_jax(dim, d, solver, bc, dtype):
    """`cmpflx` with hybrid_riemann: the HLL flux where either cell of the
    face is flagged, the solver's flux elsewhere, wall masks included."""
    JL, TL = JLayout(dim=dim, nspec=1), StateLayout(dim=dim, nspec=1)
    shape = SHAPES[dim]
    q, qaux, qm, qp = _prims(dim, 400 + dim, dtype, smooth=solver == 1)
    dx = (0.1, 0.05, 0.2)[:dim]
    shk = np.asarray(jau.shock(jnp.asarray(q), dx, JL, 0.02 if solver == 1 else 0.5))
    assert 0 < shk.sum() < shk.size
    jmask = jctu._bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim, jnp.dtype(dtype),
                            (None,) * dim)[d]
    tmask = _bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim)[d]
    ref = jr.cmpflx(jnp.asarray(qm), jnp.asarray(qp), jnp.asarray(qaux), d, JL, 0, solver,
                    SMALL_DENS, SMALL_PRES, bnd_mask=jmask, hybrid_riemann=True,
                    shk=jnp.asarray(shk.astype(dtype)))
    for use_kernels in (False, True):  # the hybrid stays torch ops either way
        got = tr.cmpflx(_t(qm), _t(qp), _t(qaux), d, TL, 0, solver, SMALL_DENS, SMALL_PRES,
                        bnd_mask=tmask, hybrid_riemann=True, shk=_t(shk.astype(dtype)),
                        use_kernels=use_kernels)
        _close(got[0], ref[0], dtype, "flux")
        _close(got[1], ref[1], dtype, "qe")
    plain = tr.cmpflx(_t(qm), _t(qp), _t(qaux), d, TL, 0, solver, SMALL_DENS, SMALL_PRES,
                      bnd_mask=tmask)
    differs = (plain[0] != got[0]).any(0).numpy()
    face = np.maximum(shk, np.concatenate(
        [np.take(shk, [0], axis=d), np.delete(shk, -1, axis=d)], axis=d)) > 0
    assert differs.any() and not (differs & ~face).any()  # HLL only on flagged faces


def test_unknown_riemann_solver_raises():
    _, _, _, tri, _ = _inputs(1, 0, 1, "float64")
    with pytest.raises(ValueError, match="riemann_solver=3"):
        tr.solve(tri, 3, SMALL_DENS, SMALL_PRES)
