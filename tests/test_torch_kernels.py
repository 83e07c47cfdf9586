"""Each kernel's plain PyTorch version against the JAX Pallas kernel function
on the same inputs (3D, n = 16 interior, float32).

The JAX side runs its Pallas kernels through the interpreter
(`pallas_kernels.INTERPRET = True`, restored in `finally`, as
tests/test_pallas.py does), so the in-kernel reductions (Courant number,
min rho, non-finite flag) are compared too. Inputs are made from a seed
with numpy and handed to both packages as numpy arrays.

Tolerance: rtol = atol = 2e-5, the fused-vs-XLA float32 budget the JAX
package already accepts (tests/test_pallas.py:41).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.eos.gamma_law import GammaLawEos as JGammaLaw
from castro_tpu.network.general_null import GeneralNullNetwork as JNull
from castro_tpu.ops import advection_util as jau
from castro_tpu.ops import ctu as jctu
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.ops.flatten import uflatten as j_uflatten
from castro_tpu.state import StateLayout as JLayout

from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.network import GeneralNullNetwork
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.ctu import _bnd_masks
from castro_tpu_torch.state import StateLayout

RTOL = ATOL = 2e-5
N, NG = 16, 4
G = N + 2 * NG
DX = (1.0 / N,) * 3
DT = np.float32(2e-3)
SMALL_DENS, SMALL_TEMP, SMALL_PRES, SMALL_ENER = 1e-12, 1e-12, 1e-20, 1e-200

JL = JLayout(dim=3, nspec=1)
TL = StateLayout(dim=3, nspec=1)
JEOS = JGammaLaw(1.4, network=JNull())
TEOS = GammaLawEos(1.4, network=GeneralNullNetwork())


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
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=what)


def _state(seed=0, bad_cells=False):
    """A random conserved state [NVAR, G, G, G] with strong jumps."""
    rng = np.random.default_rng(seed)
    shape = (G, G, G)
    rho = rng.uniform(0.5, 1.5, shape)
    vel = rng.uniform(-0.4, 0.4, (3,) + shape)
    p = rng.uniform(0.3, 2.0, shape)
    rhoe = p / 0.4
    u = np.zeros((TL.NVAR,) + shape)
    u[TL.URHO] = rho
    u[TL.UMX:TL.UMZ + 1] = rho * vel
    u[TL.UEINT] = rhoe
    u[TL.UEDEN] = rhoe + 0.5 * rho * (vel ** 2).sum(0)
    u[TL.UTEMP] = 1.0
    u[TL.UFS] = rho
    if bad_cells:
        # density floor and negative internal energy: the clean ladder's branches
        u[TL.URHO, 5, 6, 7] = 1e-14
        u[TL.UEINT, 9, 9, 9] = -1.0
        u[TL.UEDEN, 9, 9, 9] = 0.5 * u[TL.UEDEN, 9, 9, 9]
        u[TL.UEDEN, 10, 11, 12] = -3.0
    return u.astype(np.float32)


@pytest.fixture(scope="module")
def prims():
    """Primitive inputs made once by the JAX XLA functions."""
    u = jnp.asarray(_state())
    q, qaux = jau.ctoprim(u, JL, JEOS, SMALL_DENS, SMALL_TEMP)
    flatn = j_uflatten(q, JL)
    rng = np.random.default_rng(1)
    srcq = (0.05 * rng.standard_normal((JL.NQ, G, G, G))).astype(np.float32)
    return dict(u=np.asarray(u), q=np.asarray(q), qaux=np.asarray(qaux),
                flatn=np.asarray(flatn), srcq=srcq,
                div=np.asarray(jau.divu_node(q, DX, JL)))


@pytest.mark.parametrize("with_divu", [True, False], ids=["divu+courant", "no-divu"])
def test_prim_aux_plain_vs_pallas(prims, with_divu):
    cdt = DT if with_divu else None
    ref = _interpret(pk.prim_aux_pallas, jnp.asarray(prims["u"]), JL, JEOS, SMALL_DENS,
                     SMALL_TEMP, DX, with_divu=with_divu, courant_dt=cdt)
    got = K.prim_aux(_t(prims["u"]), TL, TEOS, SMALL_DENS, SMALL_TEMP, DX,
                     with_divu=with_divu, courant_dt=cdt)
    assert len(got) == len(ref)
    for name, g_, r_ in zip(("q", "qaux", "div", "courant"), got, ref):
        _close(g_, r_, name)
    assert K.prim_aux.launches == 0  # CPU tensors take the plain version


def test_flatten_plain_vs_pallas(prims):
    ref = _interpret(pk.flatten_pallas, jnp.asarray(prims["q"]), JL)
    got = K.flatten(_t(prims["q"]), TL)
    _close(got, ref)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert float(got.min()) < 1.0  # the random jumps do flatten somewhere


def _jmask(d, bc):
    return jctu._bnd_masks((G, G, G), 3, NG, (bc,) * 3, (bc,) * 3, jnp.float32,
                           (None,) * 3)[d]


def _tmask(d, bc):
    return _bnd_masks((G, G, G), 3, NG, (bc,) * 3, (bc,) * 3)[d]


@pytest.mark.parametrize("d,solver,with_src,bc", [
    (0, 0, False, 2), (1, 2, True, 3), (2, 0, True, 3), (2, 2, False, 2)],
    ids=["x-cgf", "y-hllc-src-wall", "z-cgf-src-wall", "z-hllc"])
def test_trace_ppm_plain_vs_pallas(prims, d, solver, with_src, bc):
    src = prims["srcq"] if with_src else None
    ref = _interpret(
        pk.trace_ppm_pallas, jnp.asarray(prims["q"]), jnp.asarray(prims["qaux"]),
        None if src is None else jnp.asarray(src), jnp.asarray(prims["flatn"]), d, DT,
        DX[d], JL, SMALL_DENS, SMALL_PRES, SMALL_ENER,
        fuse_riemann=dict(coord=0, riemann_solver=solver, bnd_mask=_jmask(d, bc)))
    got = K.trace_ppm(
        _t(prims["q"]), _t(prims["qaux"]), None if src is None else _t(src),
        _t(prims["flatn"]), d, DT, DX[d], TL, SMALL_DENS, SMALL_PRES, SMALL_ENER,
        fuse_riemann=dict(coord=0, riemann_solver=solver, bnd_mask=_tmask(d, bc)))
    for name, g_, r_ in zip(("qm", "qp", "flux", "qe"), got, ref):
        _close(g_, r_, name)


@pytest.fixture(scope="module")
def traced(prims):
    """Traced states and 1D fluxes of all three directions (JAX XLA path)."""
    from castro_tpu.ops.riemann import cmpflx
    from castro_tpu.ops.trace_ppm import trace_ppm

    q, qaux = jnp.asarray(prims["q"]), jnp.asarray(prims["qaux"])
    out = []
    for d in range(3):
        qm, qp = trace_ppm(q, qaux, None, jnp.asarray(prims["flatn"]), d, DT, DX[d], JL,
                           SMALL_DENS, SMALL_PRES, SMALL_ENER)
        f, qe = cmpflx(qm, qp, qaux, d, JL, 0, 0, SMALL_DENS, SMALL_PRES)
        out.append(tuple(np.asarray(a) for a in (qm, qp, f, qe)))
    return out


def _terms(traced, dirs, conv, cdt):
    return [{"flux": conv(traced[t][2]), "qe": conv(traced[t][3]), "t_dir": t,
             "cdtdx": np.float32(cdt / DX[t])} for t in dirs]


@pytest.mark.parametrize("case", ["no-terms", "pair-wall", "final", "final-consup",
                                  "final-consup-fin-hllc-wall"])
def test_ctu_face_plain_vs_pallas(prims, traced, case):
    d = {"no-terms": 0, "pair-wall": 1, "final": 2, "final-consup": 0,
         "final-consup-fin-hllc-wall": 2}[case]
    solver = 2 if "hllc" in case else 0
    bc = 3 if "wall" in case else 2
    t1, t2 = [t for t in range(3) if t != d]
    third, half = DT / np.float32(3.0), np.float32(0.5) * DT
    rng = np.random.default_rng(2)
    hsrc = (0.1 * rng.standard_normal((JL.NVAR, G, G, G))).astype(np.float32)

    def call(fn, conv, mask):
        kw = dict(bnd_mask=mask)
        if case == "no-terms":
            terms = []
        elif case == "pair-wall":
            terms = _terms(traced, [t1], conv, third)
            kw["terms2"] = _terms(traced, [t2], conv, third)
        else:
            terms = _terms(traced, [t1, t2], conv, half)
        if "consup" in case:
            kw["consup"] = dict(hsrc=conv(hsrc), div_node=conv(prims["div"]),
                                u=conv(prims["u"]), difmag=0.1, dx=DX,
                                finalize_dt=DT if "fin" in case else None)
        return fn(conv(traced[d][0]), conv(traced[d][1]), conv(prims["qaux"]), d, terms,
                  JL if conv is jnp.asarray else TL, 0, solver, SMALL_DENS, SMALL_PRES,
                  True, False, **kw)

    ref = _interpret(call, pk.ctu_face_pallas, jnp.asarray, _jmask(d, bc))
    got = call(K.ctu_face, _t, _tmask(d, bc))
    flat_ref, flat_got = jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(flat_ref) == len(flat_got)
    for i, (g_, r_) in enumerate(zip(flat_got, flat_ref)):
        _close(g_, r_, f"output {i}")


@pytest.mark.parametrize("lo,hi,with_status", [
    ((2, 2, 2), (2, 2, 2), True), ((3, 3, 3), (3, 3, 3), True),
    ((0, 0, 0), (0, 0, 0), False), ((5, 4, 0), (2, 3, 0), True)],
    ids=["outflow", "symmetry", "periodic", "noslip-slip-mixed"])
def test_clean_fill_plain_vs_pallas(lo, hi, with_status):
    u = _state(seed=3, bad_cells=True)
    args = (lo, hi, NG, SMALL_DENS, SMALL_TEMP, 1e-4, True)
    ref = _interpret(pk.clean_fill_pallas, jnp.asarray(u), JL, JEOS, *args,
                     with_status=with_status)
    got = K.clean_fill(_t(u), TL, TEOS, *args, with_status=with_status)
    if not with_status:
        ref, got = (ref,), (got,)
    _close(got[0], ref[0], "state")
    if with_status:
        _close(got[1], ref[1], "min rho")
        assert bool(got[2]) == bool(ref[2])
        # a non-finite interior value sets the flag
        u2 = u.copy()
        u2[TL.UMY, 8, 8, 8] = np.nan
        assert bool(K.clean_fill(_t(u2), TL, TEOS, *args, with_status=True)[2])
