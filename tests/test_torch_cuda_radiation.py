"""The pointwise kernels on the radiation layout, and radiation steps on
the card against the CPU.

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present. On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_radiation.py`.

On the radiation layout the primitive passives lie past QPTOT, QREITOT and
each group's Er, and a Godunov state carries each group's flux limiter and
Er: cmpflx, trans_apply and trans_cmpflx take the layout's QFS and NGDNV
at run time and write the radiation Godunov components as zeros, as their
plain versions do, so they are held bit for bit (ngroups 1 and 4, float32
and float64, Cartesian, RZ and spherical faces, wall masks). The steps
(the operator-split step through these kernels, the characteristic
rad-CTU step and the multigroup update in torch ops) are held card
against CPU at 1e-8 |cpu| + 1e-8 max|cpu| per component in float64.
"""

import numpy as np
import pytest
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.network import GeneralNullNetwork
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.advection_util import ctoprim
from castro_tpu_torch.ops.riemann import WallMask
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trans import term_bundle
from castro_tpu_torch.state import StateLayout

pytestmark = pytest.mark.cuda

F64_RTOL = 1e-8
GROUPS = pytest.mark.parametrize("ngroups", [1, 4], ids=["gray", "4groups"])
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def rad_inputs(L, shape, dtype, device, seed=0):
    """Seeded primitive states of a radiation layout: q and qaux from a
    random conserved state with random Er and flux limiters, and face
    states qm, qp perturbed from q."""
    rng = np.random.default_rng(seed)
    net = GeneralNullNetwork(spec_names=["X"] * L.nspec)
    eos = GammaLawEos(1.4, network=net, assume_neutral=False)
    rho = rng.uniform(0.5, 1.5, shape)
    vel = rng.uniform(-0.4, 0.4, (3,) + shape)
    rhoe = rng.uniform(0.3, 2.0, shape) / 0.4
    u = np.zeros((L.NVAR,) + shape)
    u[L.URHO] = rho
    u[L.UMX:L.UMZ + 1] = rho * vel
    u[L.UEINT] = rhoe
    u[L.UEDEN] = rhoe + 0.5 * rho * (vel ** 2).sum(0)
    x = rng.uniform(0.1, 1.0, (L.nspec,) + shape)
    u[L.UFS:L.UFS + L.nspec] = rho * x / x.sum(0)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    Er = t(rng.uniform(0.1, 1.0, (L.ngroups,) + shape))
    lam = t(rng.uniform(0.05, 1.0 / 3.0, (L.ngroups,) + shape))
    q, qaux = ctoprim(t(u), L, eos, 1e-12, 1e-12, Er=Er, lam=lam)
    qm = (q * t(1.0 + 0.05 * rng.standard_normal(q.shape))).contiguous()
    qp = (q * t(1.0 + 0.05 * rng.standard_normal(q.shape))).contiguous()
    return q, qaux, qm, qp


def _solve_args(L, qm, qp, qaux, d, coord, mask=None):
    c, g = qaux[L.QC], qaux[L.QGAMC]
    return (qm, qp, shifted(g, -1, d).contiguous(), g.contiguous(),
            shifted(c, -1, d).contiguous(), c.contiguous(), d, L, coord, 0, 1e-12, 1e-20, mask)


def _equal(got, ref, what):
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(a, b), f"{what}: max abs err {float((a - b).abs().max())}"


CASES = [(1, (64,), 0), (1, (128,), 2), (2, (32, 24), 0), (2, (16, 40), 1)]


@GROUPS
@DTYPES
@pytest.mark.parametrize("dim,shape,coord", CASES, ids=["1d", "1d-sph", "2d", "2d-rz"])
def test_cmpflx_radiation_layout_bit_for_bit(card, ngroups, dtype, dim, shape, coord):
    L = StateLayout(dim=dim, nspec=3, radiation=True, ngroups=ngroups)
    assert L.QFS == 8 + 2 + ngroups and L.NGDNV == 6 + 2 * ngroups
    q, qaux, qm, qp = rad_inputs(L, shape, dtype, card)
    for d in range(dim):
        for mask in (None, WallMask(d, shape[d], 4, shape[d] - 4)):
            args = _solve_args(L, qm, qp, qaux, d, coord, mask)
            before = K.cmpflx.launches
            got = K.cmpflx(*args)
            assert K.cmpflx.launches == before + 1
            ref = K.cmpflx_plain(*args)
            _equal(got, ref, f"cmpflx d={d} mask={mask is not None}")
            assert bool((got[1][6:] == 0).all())


@GROUPS
@DTYPES
def test_trans_kernels_radiation_layout_bit_for_bit(card, ngroups, dtype):
    shape = (32, 24)
    L = StateLayout(dim=2, nspec=2, radiation=True, ngroups=ngroups)
    q, qaux, qm, qp = rad_inputs(L, shape, dtype, card, seed=1)
    for n, t in ((0, 1), (1, 0)):
        f_t = K.cmpflx(*_solve_args(L, qm, qp, qaux, t, 0))
        term = [{"flux": f_t[0], "qe": f_t[1], "t_dir": t, "cdtdx": 0.3}]
        df_p, dre_p, dp_p = (a.contiguous() for a in term_bundle(term, qaux, n, 0, L))
        df_m, dre_m, dp_m = (a.contiguous() for a in term_bundle(term, qaux, n, -1, L))
        for reset in ((True, False), (False, True)):
            # trans_apply copies QPTOT, QREITOT and each group's Er through
            got = K.trans_apply(qp, df_p, dre_p, dp_p, L, 1e-20, *reset)
            ref = K.trans_apply_plain(qp, df_p, dre_p, dp_p, L, 1e-20, *reset)
            _equal(got, ref, f"trans_apply n={n} reset={reset}")
            assert torch.equal(got[L.QPTOT:L.QFS], qp[L.QPTOT:L.QFS])
            c, g = qaux[L.QC], qaux[L.QGAMC]
            args = (qm, qp, df_m, df_p, dre_m, dre_p, dp_m, dp_p, shifted(g, -1, n).contiguous(),
                    g.contiguous(), shifted(c, -1, n).contiguous(), c.contiguous(), n, L, 0, 0,
                    1e-12, 1e-20, *reset)
            _equal(K.trans_cmpflx(*args, bnd_mask=WallMask(n, shape[n], 4, -1)),
                   K.trans_cmpflx_plain(*args, bnd_mask=WallMask(n, shape[n], 4, -1)),
                   f"trans_cmpflx n={n} reset={reset}")


def test_closed_kernels_refuse_the_radiation_layout(card):
    """The 3D face kernels keep the hydro layout's QFS and NGDNV: their
    wrappers refuse a radiation layout, naming the ROADMAP item."""
    L = StateLayout(dim=3, nspec=1, radiation=True, ngroups=1)
    q = torch.zeros((L.NQ, 8, 8, 8), device=card)
    with pytest.raises(NotImplementedError, match="item 9"):
        K.flatten(q, L)


def _box(device, ngroups=1, split=1, dim=2, n=32):
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems.util import fill_from_prim

    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", lo_bc=(0,) * dim, hi_bc=(0,) * dim, do_radiation=1,
                  small_dens=1e-12, small_temp=1e-12, small_pres=1e-15, check_cfl_violation=0,
                  fixed_dt=2e-3)
    kw = dict(lowest_group_hz=1e13, highest_group_hz=1e17,
              do_inelastic_scattering=1) if ngroups > 1 else {}
    p = p.with_ns("radiation", const_kappa_p=1e-3, const_kappa_r=1e4, limiter=2,
                  ngroups=ngroups, hydro_coupling=1 - split, **kw)
    p = p.with_ns("eos", eos_gamma=5.0 / 3.0)
    p = p.with_ns("tpu", dtype="float64")

    def init(sim, u):
        x = sim.geom.cell_centers(0, sim.ng).expand(sim.grown_shape())
        rho = torch.where(x < 0.5, 1.0, 0.25)
        pres = torch.where(x < 0.5, 1.0, 0.3)
        return fill_from_prim(sim, u, rho, (0.1, 0.0, 0.0), p=pres)

    sim = Simulation(p, problem_init=init, device=device)
    sim.init_data()
    r = sum((sim.geom.cell_centers(d, 0) - 0.5) ** 2 for d in range(dim))
    sim.u_rad = sim.u_rad * 0.0 + 1e-6 + 5.0 * torch.exp(-r / 0.02)
    return sim


def _assert_f64_close(got, ref, what):
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().reshape(ref.shape[0], -1).amax(1).reshape((-1,) + (1,) * (ref.dim() - 1))
    bad = (got - ref).abs() > F64_RTOL * ref.abs() + F64_RTOL * scale
    assert not bool(bad.any()), f"{what}: max abs err {float((got - ref).abs().max())}"


@pytest.mark.parametrize("ngroups,split,dim", [(1, 1, 2), (1, 0, 2), (4, 0, 1), (1, 1, 1)],
                         ids=["split-2d", "ctu-2d", "ctu-1d-4groups-compton", "split-1d"])
def test_rad_steps_card_vs_cpu(card, ngroups, split, dim):
    sims = [_box(dev, ngroups, split, dim) for dev in (card, "cpu")]
    K.reset_launch_counts()
    for s_ in sims:
        s_.run(max_step=2, verbose=False)
    launches = K.launch_counts()
    if split:
        assert launches["cmpflx"] == 2 * dim * (1 if dim == 1 else 1)
        assert launches["trans_cmpflx"] == (2 * 2 if dim == 2 else 0)
    else:
        assert sum(launches.values()) == 0  # the rad-CTU chain is torch ops
    _assert_f64_close(sims[0].interior(), sims[1].interior(), "u")
    Er = [s_.u_rad if s_.u_rad.dim() > dim else s_.u_rad[None] for s_ in sims]
    _assert_f64_close(Er[0], Er[1], "Er")
