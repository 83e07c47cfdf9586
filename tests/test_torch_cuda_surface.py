"""cmpflx and trans_cmpflx, the two kernels of a 2D (and, cmpflx, 1D) step,
against their plain versions on the card in float64 at the layouts of the
surface-burning networks: NPASS = 10 (rprox), 13 (aprox13) and 14 (nova);
on seeded face states, and on the face states of the initial states of
flame_wave, xrb_mixed and nova (Helmholtz, their HSE columns) at small
sizes.

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present. On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_surface.py`. Both kernels repeat their plain
versions' operations in the same order, so they are held bit for bit
(NaN where both are NaN).
"""

import pytest
import torch

from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.ctu import _bnd_masks
from castro_tpu_torch.ops.flatten import uflatten
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trace_ppm import trace_ppm
from castro_tpu_torch.ops.trans import term_bundle
from castro_tpu_torch.problems import flame_wave, nova, xrb_mixed
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.state import StateLayout
from test_torch_cuda_layouts import NG, SHAPE, SMALL, _exact, _face_inputs

pytestmark = pytest.mark.cuda

NPASS = pytest.mark.parametrize("nspec", [10, 13, 14], ids=["rprox", "aprox13", "nova"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@NPASS
@pytest.mark.parametrize("dim", [1, 2])
def test_cmpflx_trans_cmpflx_float64(card, nspec, dim):
    """Seeded face states, CGF with outflow faces and HLLC with walls."""
    L = StateLayout(dim=dim, nspec=nspec)
    shape = SHAPE[:dim] if dim > 1 else (SHAPE[2] * 4,)
    qm, qp, aux, bm, bp = _face_inputs(L, torch.float64, card, shape, seed=nspec)
    for solver, bc in ((0, 2), (2, 3)):
        for d in range(dim):
            mask = _bnd_masks(shape, dim, NG, (bc,) * dim, (bc,) * dim)[d]
            args = (qm, qp, *aux, d, L, 0, solver, SMALL["small_dens"], SMALL["small_pres"])
            _exact(K.cmpflx(*args, bnd_mask=mask), K.cmpflx_plain(*args, bnd_mask=mask),
                   f"cmpflx d={d}")
            if dim == 1:
                continue
            args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux, d, L, 0, solver,
                    SMALL["small_dens"], SMALL["small_pres"], True, False)
            _exact(K.trans_cmpflx(*args, bnd_mask=mask),
                   K.trans_cmpflx_plain(*args, bnd_mask=mask), f"trans_cmpflx d={d}")


def _problem_sim(name, device):
    if name == "flame_wave":
        return flame_wave.build(n=(64, 32), device=device)
    mod = {"xrb_mixed": xrb_mixed, "nova": nova}[name]
    return Simulation(mod.make_params(n=(16, 48)), problem_init=mod.problem_init, device=device)


@pytest.mark.parametrize("name", ["flame_wave", "xrb_mixed", "nova"])
def test_kernels_on_problem_states(card, name):
    """The two kernels on the face states a step of the problem makes from
    its initial state (torch-op ctoprim, flattening and PPM trace, as the
    2D step does), both directions, the final stage's bundles included."""
    sim = _problem_sim(name, card)
    sim.init_data()
    u, L, cfg = sim.u, sim.layout, sim.cfg
    assert u.dtype == torch.float64 and L.nspec in (10, 13, 14)
    dt = K.wt(sim.estimate_dt(), u.dtype)
    q, qaux = au.ctoprim(u, L, sim.eos, cfg.small_dens, sim.small_temp)
    flatn = uflatten(q, L) if cfg.use_flattening else None
    masks = _bnd_masks(u.shape[1:], 2, sim.ng, cfg.lo_bc, cfg.hi_bc)
    g, c = qaux[L.QGAMC], qaux[L.QC]
    solves, f1d = [], []
    for d in range(2):
        qm, qp = trace_ppm(q, qaux, None, flatn, d, dt, sim.geom.dx[d], L, cfg.small_dens,
                           cfg.small_pres, cfg.small_ener)
        a = (qm, qp, shifted(g, -1, d), g, shifted(c, -1, d), c, d, L, 0, 0, cfg.small_dens,
             cfg.small_pres)
        ref = K.cmpflx_plain(*a, bnd_mask=masks[d])
        _exact(K.cmpflx(*a, bnd_mask=masks[d]), ref, f"{name} cmpflx d={d}")
        solves.append(a)
        f1d.append(ref)
    for n, t in ((0, 1), (1, 0)):
        term = [{"flux": f1d[t][0], "qe": f1d[t][1], "t_dir": t,
                 "cdtdx": 0.5 * dt / sim.geom.dx[t]}]
        bp, bm = term_bundle(term, qaux, n, 0, L), term_bundle(term, qaux, n, -1, L)
        a = (solves[n][0], solves[n][1], bm[0], bp[0], bm[1], bp[1], bm[2], bp[2],
             *solves[n][2:6], n, L, 0, 0, cfg.small_dens, cfg.small_pres, True, False)
        _exact(K.trans_cmpflx(*a, bnd_mask=masks[n]), K.trans_cmpflx_plain(*a, bnd_mask=masks[n]),
               f"{name} trans_cmpflx n={n}")
