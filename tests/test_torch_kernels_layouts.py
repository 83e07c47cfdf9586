"""The kernels' plain PyTorch versions against the JAX Pallas kernel
functions at the reacting layouts: 7 and 19 species, the shock flag, and
an aux component (3D, n = 12 interior, float32), as
tests/test_torch_kernels.py holds them at one species.

The JAX side runs its Pallas kernels through the interpreter
(`pallas_kernels.INTERPRET = True`, restored in `finally`). Inputs are
made from a seed with numpy and handed to both packages as numpy arrays.
Tolerance: rtol = atol = 2e-5, the fused-vs-XLA float32 budget the JAX
package already accepts (tests/test_pallas.py:41).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.gamma_law import GammaLawEos as JGammaLaw
from castro_tpu.network.general_null import GeneralNullNetwork as JNull
from castro_tpu.ops import advection_util as jau
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.ops.flatten import uflatten as j_uflatten
from castro_tpu.ops.riemann import cmpflx as j_cmpflx
from castro_tpu.ops.trace_ppm import trace_ppm as j_trace_ppm
from castro_tpu.state import StateLayout as JLayout
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.network import GeneralNullNetwork
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.state import StateLayout

RTOL = ATOL = 2e-5
N, NG = 12, 4
G = N + 2 * NG
DX = (1.0 / N,) * 3
DT = np.float32(2e-3)
SMALL_DENS, SMALL_TEMP, SMALL_PRES, SMALL_ENER = 1e-12, 1e-12, 1e-20, 1e-200
NAMES = ("He4", "C12", "O16", "Ne20", "Mg24", "Si28", "Fe56")
# (nspec, naux, shock flag)
LAYOUTS = {"iso7": (7, 0, False), "aprox19": (19, 0, False), "iso7-shock": (7, 0, True),
           "iso7-aux": (7, 1, False)}


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


@pytest.fixture(scope="module", params=list(LAYOUTS))
def case(request):
    return _case(request.param)


def _case(name):
    """Both packages' layout and EOS, a random state with strong jumps, and
    its primitives, flattening and 1D traces (the JAX XLA functions)."""
    nspec, naux, shock = LAYOUTS[name]
    names = [NAMES[i % len(NAMES)] for i in range(nspec)]
    jl = JLayout(dim=3, nspec=nspec, naux=naux, shock_var=shock)
    tl = StateLayout(dim=3, nspec=nspec, naux=naux, shock_var=shock)
    jeos = JGammaLaw(1.4, network=JNull(names), assume_neutral=False)
    teos = GammaLawEos(1.4, network=GeneralNullNetwork(names), assume_neutral=False)
    rng = np.random.default_rng(0)
    shape = (G, G, G)
    rho = rng.uniform(0.5, 1.5, shape)
    vel = rng.uniform(-0.4, 0.4, (3,) + shape)
    rhoe = rng.uniform(0.3, 2.0, shape) / 0.4
    u = np.zeros((tl.NVAR,) + shape)
    u[tl.URHO] = rho
    u[tl.UMX:tl.UMZ + 1] = rho * vel
    u[tl.UEINT] = rhoe
    u[tl.UEDEN] = rhoe + 0.5 * rho * (vel ** 2).sum(0)
    u[tl.UTEMP] = 1.0
    x = rng.uniform(0.0, 1.0, (nspec,) + shape)
    u[tl.UFS:tl.UFS + nspec] = rho * x / x.sum(0)
    if naux:
        u[tl.UFX:tl.UFX + naux] = rho * rng.uniform(0.4, 0.6, (naux,) + shape)
    if shock:
        u[tl.USHK] = rng.integers(0, 2, shape)
    u = u.astype(np.float32)
    q, qaux = jau.ctoprim(jnp.asarray(u), jl, jeos, SMALL_DENS, SMALL_TEMP)
    flatn = j_uflatten(q, jl)
    tr = []
    for d in range(3):
        qm, qp = j_trace_ppm(q, qaux, None, flatn, d, DT, DX[d], jl, SMALL_DENS, SMALL_PRES,
                             SMALL_ENER)
        f, qe = j_cmpflx(qm, qp, qaux, d, jl, 0, 0, SMALL_DENS, SMALL_PRES)
        tr.append(tuple(np.asarray(a) for a in (qm, qp, f, qe)))
    return dict(jl=jl, tl=tl, jeos=jeos, teos=teos, u=u, q=np.asarray(q),
                qaux=np.asarray(qaux), flatn=np.asarray(flatn), tr=tr,
                div=np.asarray(jau.divu_node(q, DX, jl)), name=name)


def test_cell_kernels_plain_vs_pallas(case):
    """prim_aux (div u and Courant), flatten, clean_fill with status."""
    c = case
    ref = _interpret(pk.prim_aux_pallas, jnp.asarray(c["u"]), c["jl"], c["jeos"], SMALL_DENS,
                     SMALL_TEMP, DX, courant_dt=DT)
    got = K.prim_aux(_t(c["u"]), c["tl"], c["teos"], SMALL_DENS, SMALL_TEMP, DX,
                     courant_dt=DT)
    for name, g_, r_ in zip(("q", "qaux", "div", "courant"), got, ref):
        _close(g_, r_, f"{c['name']} prim_aux {name}")
    _close(K.flatten(_t(c["q"]), c["tl"]), _interpret(pk.flatten_pallas, jnp.asarray(c["q"]),
                                                      c["jl"]), "flatten")
    raw = c["u"].copy()
    raw[c["tl"].URHO, 5, 6, 7] = 1e-14
    raw[c["tl"].UEDEN, 10, 11, 12] = -3.0
    args = ((2, 2, 2), (2, 2, 2), NG, SMALL_DENS, SMALL_TEMP, 1e-4, True)
    ref = _interpret(pk.clean_fill_pallas, jnp.asarray(raw), c["jl"], c["jeos"], *args,
                     with_status=True)
    got = K.clean_fill(_t(raw), c["tl"], c["teos"], *args, with_status=True)
    _close(got[0], ref[0], "clean_fill state")
    _close(got[1], ref[1], "min rho")
    assert bool(got[2]) == bool(ref[2])


def test_face_kernels_plain_vs_pallas(case):
    """trace_ppm with the fused solve (HLLC) and ctu_face's final stage
    with consup and the update folded, along z."""
    c = case
    d = 2
    ref = _interpret(pk.trace_ppm_pallas, jnp.asarray(c["q"]), jnp.asarray(c["qaux"]), None,
                     jnp.asarray(c["flatn"]), d, DT, DX[d], c["jl"], SMALL_DENS, SMALL_PRES,
                     SMALL_ENER, fuse_riemann=dict(coord=0, riemann_solver=2, bnd_mask=None))
    got = K.trace_ppm(_t(c["q"]), _t(c["qaux"]), None, _t(c["flatn"]), d, DT, DX[d], c["tl"],
                      SMALL_DENS, SMALL_PRES, SMALL_ENER,
                      fuse_riemann=dict(coord=0, riemann_solver=2, bnd_mask=None))
    for name, g_, r_ in zip(("qm", "qp", "flux", "qe"), got, ref):
        _close(g_, r_, f"{c['name']} trace_ppm {name}")
    half = np.float32(0.5) * DT
    rng = np.random.default_rng(2)
    hsrc = (0.1 * rng.standard_normal(c["u"].shape)).astype(np.float32)
    tr = c["tr"]

    def call(fn, conv, lay):
        terms = [{"flux": conv(tr[t][2]), "qe": conv(tr[t][3]), "t_dir": t,
                  "cdtdx": np.float32(half / DX[t])} for t in (0, 1)]
        cs = dict(hsrc=conv(hsrc), div_node=conv(c["div"]), u=conv(c["u"]),
                  difmag=0.1, dx=DX, finalize_dt=DT)
        return fn(conv(tr[d][0]), conv(tr[d][1]), conv(c["qaux"]), d, terms, lay, 0, 0,
                  SMALL_DENS, SMALL_PRES, True, False, consup=cs)

    ref = jax.tree_util.tree_leaves(_interpret(call, pk.ctu_face_pallas, jnp.asarray, c["jl"]))
    got = jax.tree_util.tree_leaves(call(K.ctu_face, _t, c["tl"]),
                                    is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(got) == len(ref)
    L = c["tl"]
    for i, (g_, r_) in enumerate(zip(got, ref)):
        if i == len(got) - 1 and L.shock_var:
            # the update's USHK row: the JAX fused route sets it after the
            # kernel (ctu.py:418), the kernel's own row is not read
            g_, r_ = np.delete(g_.numpy(), L.USHK, 0), np.delete(r_, L.USHK, 0)
        _close(g_, r_, f"{c['name']} ctu_face output {i}")
