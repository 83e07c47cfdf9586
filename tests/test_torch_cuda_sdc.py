"""The kernel and the loop that SDC runs on the card, against their plain
versions: cmpflx bit for bit on the face states of a MOL-4 evaluation
(`ops/fourth_order.py:mol4_face_states`: the face-average states and their
face-centre transforms, every direction of a 3D acoustic pulse, CGF and
HLLC, float64 and float32), and the forced burner's iteration replayed as
a CUDA graph against the same iteration run eagerly on the card, bit for
bit, at a capped iteration count (powerlaw and iso7 zones with an
advective forcing).

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present. On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_sdc.py`.
"""

import numpy as np
import pytest
import torch

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.integrators.stiff import make_burner
from castro_tpu_torch.network.iso7 import Iso7Network
from castro_tpu_torch.network.powerlaw import PowerLawNetwork
from castro_tpu_torch.ops import fourth_order as t4
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.problems import acoustic_pulse as ap

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _exact(got, ref, what):
    for i, (g_, r_) in enumerate(zip(got, ref)):
        same = (g_ == r_) | (torch.isnan(g_) & torch.isnan(r_))
        assert bool(same.all()), f"{what} output {i}: {int((~same).sum())} elements differ"


def mol4_solves(sim, u):
    """Every cmpflx argument tuple of one MOL-4 evaluation of u: per
    direction the face-centre states, then the face-average states."""
    L, cfg = sim.layout, sim.cfg
    q_cc, q_avg, qaux, flatn = t4.mol4_prims(sim._fill(u), L, cfg, sim.eos, sim.small_temp)
    c, g = qaux[L.QC], qaux[L.QGAMC]
    out = []
    for d in range(L.dim):
        qm, qp = t4.mol4_face_states(q_cc, q_avg, flatn, d, L)
        aux = (shifted(g, -1, d), g, shifted(c, -1, d), c)
        for a, b in ((t4.face_avg_to_center(qm, d, L.dim), t4.face_avg_to_center(qp, d, L.dim)),
                     (qm, qp)):
            out.append((a.contiguous(), b.contiguous(), *aux, d, L, sim.geom.coord,
                        cfg.riemann_solver, cfg.small_dens, cfg.small_pres))
    return out


@pytest.mark.parametrize("solver", [0, 2])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cmpflx_on_mol4_faces(card, dtype, solver):
    p = ap.make_params(n=24, dim=3, dtype=dtype).with_ns(
        "castro", time_integration_method=2, sdc_order=4, riemann_solver=solver)
    sim = Simulation(p, problem_init=ap.problem_init, device=card)
    sim.init_data()
    sim.u = sim._clean_fill_impl(t4.cell_center_to_avg(sim.u, 3))
    u, status = sim.try_step(sim.estimate_dt())  # the faces of a stepped state too
    assert status.success
    for state in (sim.u, u):
        solves = mol4_solves(sim, state)
        assert len(solves) == 6
        for k, args in enumerate(solves):
            _exact(K.cmpflx(*args), K.cmpflx_plain(*args), f"{dtype} solve {k}")


CASES = {"powerlaw": (lambda: PowerLawNetwork(rtilde=10.0, nu=4.0, specific_q_burn=5.0),
                      1.0, 3.0, 4e-3),
         "iso7": (Iso7Network, 1e7, 1.5e9, 2e-8)}


@pytest.mark.parametrize("name", list(CASES))
def test_forced_burner_graph_matches_eager(card, name):
    """64 zones, at most 6 iterations: the captured graph (and a replay of
    the kept one) against the eager iteration, bit for bit."""
    net_f, rho0, T0, dt = CASES[name]
    net = net_f()
    eos = GammaLawEos(1.4, network=net)
    rng = np.random.default_rng(3)
    n = 64
    rho = torch.tensor(rho0 * rng.uniform(0.5, 2.0, n), device=card)
    T = torch.tensor(T0 * rng.uniform(0.8, 1.2, n), device=card)
    x = rng.uniform(0.0, 1.0, (net.nspec, n))
    x = torch.tensor(x / x.sum(0), device=card)
    e = eos.rt(rho=rho, T=T, xn=x).e
    xf = rng.uniform(-0.05, 0.05, (net.nspec, n)) / dt
    xf = torch.tensor(xf - xf.mean(0), device=card)
    ef = torch.tensor(rng.uniform(-0.05, 0.05, n), device=card) * e / dt
    burn = make_burner(net, eos, max_substeps=6, rtol=1e-6, atol_x=1e-8, atol_e=1e-6,
                       with_forcing=True)
    burn.use_graph = False
    eager = burn(rho, T, x, e, dt, xdot_force=xf, edot_force=ef)
    steps = burn.stats.zone_steps.clone()
    burn.use_graph = True
    for _ in range(2):  # the capture, then a replay of the kept graph
        graph = burn(rho, T, x, e, dt, xdot_force=xf, edot_force=ef)
        assert all(torch.equal(a, b) for a, b in zip(eager, graph))
        assert torch.equal(burn.stats.zone_steps, steps)
    assert burn.stats.iterations == 6 or not bool(eager[2].any())
