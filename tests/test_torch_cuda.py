"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present (the decision is made there, never at import). On the card:
`python -m pytest -m cuda tests/test_torch_cuda.py`.

Inputs are random states from a seed on a grown grid that is not a cube
(so that an axis mix-up shows), compared in float64 with rtol = atol =
1e-9 (the kernel repeats the plain arithmetic without FMA contraction;
what differs is round-off) and in float32 with rtol = atol = 2e-5 (the
budget of tests/test_pallas.py:41).
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
from castro_tpu_torch.state import StateLayout

pytestmark = pytest.mark.cuda

NG = 4
SHAPE = (20, 24, 28)  # grown extents
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


def _state(seed, dtype, device, bad_cells=False):
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.5, 1.5, SHAPE)
    vel = rng.uniform(-0.4, 0.4, (3,) + SHAPE)
    rhoe = rng.uniform(0.3, 2.0, SHAPE) / 0.4
    u = np.zeros((L.NVAR,) + SHAPE)
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


def _masks(bc):
    return _bnd_masks(SHAPE, 3, NG, (bc,) * 3, (bc,) * 3)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["f32", "f64"])


@DTYPES
def test_prim_aux_and_flatten_kernels(card, dtype):
    u = _state(0, dtype, card)
    before = K.prim_aux.launches
    got = K.prim_aux(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"], DX,
                     courant_dt=DT)
    ref = K.prim_aux_plain(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"], DX,
                           courant_dt=DT)
    assert K.prim_aux.launches == before + 1
    for name, g_, r_ in zip(("q", "qaux", "div", "courant"), got, ref):
        _close(g_, r_, dtype, name)
    _close(K.flatten(got[0], L), uflatten(got[0], L), dtype, "flatn")


@DTYPES
@pytest.mark.parametrize("solver,with_src,bc", [(0, False, 2), (2, True, 3)],
                         ids=["cgf", "hllc-src-wall"])
def test_trace_ppm_kernel(card, dtype, solver, with_src, bc):
    u = _state(1, dtype, card)
    q, qaux = ctoprim(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    src = 0.05 * torch.randn(q.shape, dtype=dtype, device=card,
                             generator=torch.Generator(card).manual_seed(1)) if with_src else None
    for d in range(3):
        fr = dict(coord=0, riemann_solver=solver, bnd_mask=_masks(bc)[d])
        args = (q, qaux, src, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                SMALL["small_pres"], SMALL["small_ener"])
        got = K.trace_ppm(*args, fuse_riemann=fr)
        ref = K.trace_ppm_plain(*args, fuse_riemann=fr)
        for name, g_, r_ in zip(("qm", "qp", "flux", "qe"), got, ref):
            _close(g_, r_, dtype, f"d={d} {name}")


@DTYPES
@pytest.mark.parametrize("case", ["no-terms", "corner", "pair", "final", "final-consup-fin"])
def test_ctu_face_kernel(card, dtype, case):
    u = _state(2, dtype, card)
    q, qaux = ctoprim(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"])
    flatn = uflatten(q, L)
    tr = [K.trace_ppm_plain(q, qaux, None, flatn, d, DT, DX[d], L, SMALL["small_dens"],
                            SMALL["small_pres"], SMALL["small_ener"],
                            fuse_riemann=dict(coord=0, riemann_solver=0))
          for d in range(3)]
    div = K.prim_aux_plain(u, L, EOS, SMALL["small_dens"], SMALL["small_temp"], DX)[2]
    bc = 3 if case in ("pair", "final-consup-fin") else 2
    for d in range(3):
        t1, t2 = [t for t in range(3) if t != d]

        def term(t, f):
            return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * DT / DX[t]}

        kw = dict(bnd_mask=_masks(bc)[d])
        terms = []
        if case == "corner":
            terms = [term(t1, 1 / 3)]
        elif case == "pair":
            terms, kw["terms2"] = [term(t1, 1 / 3)], [term(t2, 1 / 3)]
        elif case.startswith("final"):
            terms = [term(t1, 0.5), term(t2, 0.5)]
        if "consup" in case:
            kw["consup"] = dict(hsrc=0.1 * u, div_node=div, u=u, difmag=0.1, dx=DX,
                                finalize_dt=DT if d == 2 else None)
        args = (tr[d][0], tr[d][1], qaux, d, terms, L, 0, 0, SMALL["small_dens"],
                SMALL["small_pres"], True, False)
        got = K.ctu_face(*args, **kw)
        ref = K.ctu_face_plain(*args, **kw)
        flat = lambda o: [o] if isinstance(o, torch.Tensor) else [x for i in o for x in flat(i)]
        for i, (g_, r_) in enumerate(zip(flat(got), flat(ref))):
            _close(g_, r_, dtype, f"d={d} output {i}")


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


def test_wrappers_refuse_bad_inputs(card):
    u = _state(0, torch.float32, card)
    with pytest.raises(TypeError):
        K.flatten(torch.zeros((L.NQ,) + SHAPE, dtype=torch.float16, device=card), L)
    with pytest.raises(ValueError):
        K.prim_aux(u[:, :, :, ::2], L, EOS, 1e-12, 1e-12, DX)
    with pytest.raises(NotImplementedError):
        K.prim_aux(torch.zeros((9,) + SHAPE, device=card), StateLayout(dim=3, nspec=2),
                   GammaLawEos(1.4, network=GeneralNullNetwork(("X", "Y"))), 1e-12, 1e-12, DX)


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
