"""cmpflx and trans_cmpflx, the kernels of a 1D or 2D step, against their
plain versions on the card in float64 at the layouts of the science
setups of ROADMAP item 7: NPASS = 3 (general_null He/C/O: wdmerger, the
convection tests), 17 (subch: subchandra), 19 (aprox19: massive_star,
nse_test) and 21 (aprox21); on seeded face states, Cartesian and
curvilinear (cmpflx with coord 1 and 2), and on the face states of the
initial states of subchandra (1D spherical and 2D RZ) and massive_star
(1D spherical) at small sizes. Then the loops replayed as CUDA graphs
(`utils/cuda_graph.py:GraphLoop`): the burner's against the CPU's eager
loop, the NSE bisection's against its eager loop on the card.

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present. On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_science.py`. Held bit for bit (NaN where both are
NaN).
"""

import numpy as np
import pytest
import torch

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.ctu import _bnd_masks
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trace_ppm import trace_ppm
from castro_tpu_torch.problems import massive_star, subchandra
from castro_tpu_torch.state import StateLayout
from test_torch_cuda_layouts import NG, SHAPE, SMALL, _exact, _face_inputs

pytestmark = pytest.mark.cuda

NPASS = pytest.mark.parametrize("nspec", [3, 17, 19, 21],
                                ids=["general_null", "subch", "aprox19", "aprox21"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@NPASS
@pytest.mark.parametrize("dim", [1, 2])
def test_cmpflx_trans_cmpflx_float64(card, nspec, dim):
    """Seeded face states: CGF with outflow faces and HLLC with walls,
    Cartesian; CGF in the curvilinear geometry of the dimension."""
    L = StateLayout(dim=dim, nspec=nspec)
    shape = SHAPE[:dim] if dim > 1 else (SHAPE[2] * 4,)
    qm, qp, aux, bm, bp = _face_inputs(L, torch.float64, card, shape, seed=nspec)
    for solver, bc, coord in ((0, 2, 0), (2, 3, 0), (0, 2, dim)):
        for d in range(dim):
            mask = _bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim)[d]
            args = (qm, qp, *aux, d, L, coord, solver, SMALL["small_dens"],
                    SMALL["small_pres"])
            _exact(K.cmpflx(*args, bnd_mask=mask), K.cmpflx_plain(*args, bnd_mask=mask),
                   f"cmpflx d={d} coord {coord}")
            if dim == 1 or coord:
                continue
            args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux, d, L, 0, solver,
                    SMALL["small_dens"], SMALL["small_pres"], True, False)
            _exact(K.trans_cmpflx(*args, bnd_mask=mask),
                   K.trans_cmpflx_plain(*args, bnd_mask=mask), f"trans_cmpflx d={d}")


def _sim(name, card):
    if name == "subchandra-1d":
        sim = Simulation(subchandra.make_params(dim=1, n=64), device=card,
                         problem_init=lambda s, u: subchandra.problem_init(s, u, model))
        model = subchandra.build_model(sim, nshell=128)
    elif name == "subchandra-rz":
        sim = Simulation(subchandra.make_params(n=(32, 64)), device=card,
                         problem_init=lambda s, u: subchandra.problem_init(s, u, model))
        model = subchandra.build_model(sim, nshell=128)
    else:
        sim = Simulation(massive_star.make_params(n=64), device=card,
                         problem_init=lambda s, u: massive_star.problem_init(s, u, model))
        model = massive_star.build_model(sim, nshell=256)
    return sim


@pytest.mark.parametrize("name", ["subchandra-1d", "subchandra-rz", "massive_star-1d"])
def test_cmpflx_on_problem_states(card, name):
    """cmpflx on the face states a step makes from the initial state (the
    torch-op ctoprim and PPM trace), in the problem's own geometry."""
    sim = _sim(name, card)
    sim.init_data()
    u, L, cfg = sim.u, sim.layout, sim.cfg
    assert u.dtype == torch.float64 and L.nspec in (17, 19)
    dt = K.wt(sim.estimate_dt(), u.dtype)
    q, qaux = au.ctoprim(u, L, sim.eos, cfg.small_dens, sim.small_temp)
    masks = _bnd_masks(u.shape[1:], L.dim, sim.ng, cfg.lo_bc, cfg.hi_bc)
    flatn = K.flatten_plain(q, L)
    g, c = qaux[L.QGAMC], qaux[L.QC]
    for d in range(L.dim):
        qm, qp = trace_ppm(q, qaux, None, flatn, d, dt, sim.geom.dx[d], L, cfg.small_dens,
                           cfg.small_pres, cfg.small_ener)
        a = (qm, qp, shifted(g, -1, d), g, shifted(c, -1, d), c, d, L, int(sim.geom.coord), 0,
             cfg.small_dens, cfg.small_pres)
        _exact(K.cmpflx(*a, bnd_mask=masks[d]), K.cmpflx_plain(*a, bnd_mask=masks[d]),
               f"{name} cmpflx d={d}")


def burn_zones(net):
    """aprox19 zones (rho, T, X): an iron core in NSE, silicon burning,
    carbon/oxygen burning, helium burning and a cold inert zone."""
    names = net.spec_names
    conds = [(5e9, 8e9, {"Fe54": 0.4, "Ni56": 0.3, "n": 0.1, "p": 0.1, "He4": 0.1}),
             (1e8, 4e9, {"Si28": 0.6, "S32": 0.3, "O16": 0.1}),
             (1e9, 2.5e9, {"C12": 0.5, "O16": 0.5}),
             (1e6, 1.0e9, {"He4": 0.9, "C12": 0.1}),
             (1e4, 1e8, {"H1": 0.7, "He4": 0.3})]
    rho = np.array([c[0] for c in conds])
    T = np.array([c[1] for c in conds])
    x = np.full((net.nspec, len(conds)), 1e-12)
    for j, (_, _, comp) in enumerate(conds):
        for name, v in comp.items():
            x[names.index(name), j] = v
    return rho, T, x / x.sum(0)


def _burn_zones(net, device):
    return tuple(torch.tensor(a, device=device) for a in burn_zones(net))


def test_burner_graph_matches_cpu(card):
    """The burner's loop replayed as a CUDA graph on the card against the
    same loop run eagerly on the CPU, at a cap the iron core reaches: the
    state within 1e-10, the failure flags, each zone's steps and the
    iterations equal; a second call, replaying the kept graph, bit for bit
    the first."""
    from castro_tpu_torch.eos.helmholtz import HelmholtzEos
    from castro_tpu_torch.integrators.stiff import make_burner
    from castro_tpu_torch.network.aprox19 import Aprox19Network

    out = {}
    for dev in ("cpu", card):
        net = Aprox19Network()
        eos = HelmholtzEos(network=net)
        rho, T, x = _burn_zones(net, dev)
        e = eos.rt(rho=rho, T=T, xn=x).e
        burn = make_burner(net, eos, max_substeps=12, rtol=1e-6, atol_x=1e-8, atol_e=1e-6)
        xn, en, fail = burn(rho, T, x, e, 1e-4)
        out[str(dev)] = (xn.cpu(), en.cpu(), fail.cpu(), burn.stats.zone_steps.cpu(),
                         burn.stats.iterations)
        if dev != "cpu":
            again = burn(rho, T, x, e, 1e-4)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(again, out[str(dev)][:3]))
    (gx, ge, gf, gs, gi), (cx, ce, cf, cs, ci) = out[str(card)], out["cpu"]
    assert float((gx - cx).abs().max()) <= 1e-10
    assert float(((ge - ce) / ce).abs().max()) <= 1e-10
    assert gf.tolist() == cf.tolist() and gf.tolist()[0]
    assert gs.tolist() == cs.tolist() and gi == ci == 12


def test_nse_bisection_graph_matches_eager(card):
    """The NSE temperature's bisection replayed as a CUDA graph against the
    eager loop on the card, bit for bit."""
    import dataclasses as dc

    from castro_tpu_torch.config import Params
    from castro_tpu_torch.eos import make_eos
    from castro_tpu_torch.network import make_network
    from castro_tpu_torch.reactions.strang import StrangReactor
    from castro_tpu_torch.state import layout_from_params

    p = Params().with_ns("network", network_name="aprox19", nse=1)
    p = p.with_ns("eos", eos_name="helmholtz").with_ns("tpu", dtype="float64")
    net = make_network(p)
    p = dc.replace(p, network=dc.replace(p.network, nspec=net.nspec, spec_names=net.spec_names))
    eos = make_eos(p, net)
    reactor = StrangReactor(p, net, eos, layout_from_params(p))
    rho, T, x = _burn_zones(net, card)
    e = eos.rt(rho=rho, T=T, xn=x).e
    ye = torch.sum(net.column(net.zion / net.aion, x, 1) * x, dim=0).clamp(1e-3, 1.0)
    eager = reactor._bisect(rho, ye, x, e, n=8, graph=False)
    for _ in range(2):  # the capture, then a replay of the kept graph
        graph = reactor._bisect(rho, ye, x, e, n=8)
        assert all(torch.equal(a, b) for a, b in zip(eager, graph))
