"""The Riemann-block tiling probe and the copy roofline probe.

    python -m castro_tpu_torch.scripts.prof_cmpflx [n=120] [reps=30] [device=cpu]

Counterpart of `scripts/prof_cmpflx.py`: from a 3D Sedov state (n=120,
128^3 grown, float32; r_init 0.1, exp_energy 0.5), ctoprim, the flattening
and the PPM trace of direction 0 without the solve at dt = 1e-4 give the
face states; gl and cl are gamc and c rolled by one cell along x, gr and cr
unrolled. Then it times `probes.probe_cmpflx` (the Riemann solve of
direction 0) at the TPU script's six tilings, mapped onto thread blocks
(ops/probes.py:TPU_TILINGS), and at the best shape, and `probes.probe_copy`
beside the bytes it moves. Every line of numbers carries the card's name
and power limit. On the card unless device=cpu, where the plain versions
run and the times are the CPU's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops import probes as P
from castro_tpu_torch.ops.flatten import uflatten
from castro_tpu_torch.problems import sedov
from castro_tpu_torch.scripts.common import card_label, mean_ms, parse_args

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
DT = 1e-4


def sedov_sim(n=120, device=None):
    """The 3D Sedov simulation of the profile, initialized."""
    params = sedov.make_params(n=n, dim=3, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                               dtype="float32")
    sim = Simulation(params, problem_init=sedov.problem_init, device=device)
    sim.init_data()
    return sim


def setup(n=120, device=None):
    """The probes' inputs: dict(qm, qp, gl, gr, cl, cr, layout, coord,
    small_dens, small_pres)."""
    sim = sedov_sim(n, device)
    return face_inputs(sim, sim.u)


def face_inputs(sim, u):
    """The probes' inputs made from the state `u` of `sim`."""
    L, cfg = sim.layout, sim.cfg
    q, qaux = au.ctoprim(u, L, sim.eos, cfg.small_dens, 1e-200)
    flatn = uflatten(q, L)
    dt = np.float32(DT)
    qm, qp = K.trace_ppm(q, qaux, None, flatn, 0, dt, sim.geom.dx[0], L, cfg.small_dens,
                         cfg.small_pres, cfg.small_ener)
    g, c = qaux[L.QGAMC], qaux[L.QC]
    return dict(qm=qm, qp=qp, gl=torch.roll(g, 1, 0).contiguous(), gr=g.contiguous(),
                cl=torch.roll(c, 1, 0).contiguous(), cr=c.contiguous(), layout=L,
                coord=int(sim.geom.coord), small_dens=cfg.small_dens, small_pres=cfg.small_pres)


def tilings(grid):
    """{label: (tile, threads)}: the TPU's six and the best shape."""
    out = {f"cmpflx {k}": (v, P.THREADS) for k, v in P.TPU_TILINGS.items()}
    out[f"cmpflx {P.BEST_TILE} x {P.THREADS} threads (one cell a thread)"] = (
        P.BEST_TILE, P.THREADS)
    return out


def cmpflx_args(x):
    return (x["qm"], x["qp"], x["gl"], x["gr"], x["cl"], x["cr"], x["layout"], x["coord"],
            x["small_dens"], x["small_pres"])


def copy_bytes(x):
    """The bytes probe_copy moves: qm[:NVAR] and qp[:NVAR] read, flux [NVAR]
    and qe [NGDNV] written (qe's qm[:NGDNV] is read with the flux)."""
    L = x["layout"]
    S = x["qm"][0].numel()
    return (2 * L.NVAR + L.NVAR + L.NGDNV) * S * x["qm"].element_size()


def run(x, reps=30, out=print):
    """Time every tiling and the copy probe; returns {label: ms}."""
    device = x["qm"].device
    label = card_label(device)
    args = cmpflx_args(x)
    res = {}
    for name, (tile, threads) in tilings(x["qm"].shape[1:]).items():
        ms = mean_ms(lambda: P.probe_cmpflx(*args, tile=tile, threads=threads), device, reps)
        res[name] = ms
        out(f"{name:52s} {ms:8.4f} ms  [{label}]")
    nbytes = copy_bytes(x)
    ms = mean_ms(lambda: P.probe_copy(x["qm"], x["qp"], x["layout"], tile=(8, None),
                                      threads=P.THREADS), device, reps)
    res["copy-roofline (8,) same IO"] = ms
    out(f"{'copy-roofline (8,) same IO':52s} {ms:8.4f} ms  moves {nbytes / 1e6:.1f} MB, "
        f"{nbytes / ms / 1e6:.1f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}  [{label}]")
    ms = mean_ms(lambda: P.probe_copy(x["qm"], x["qp"], x["layout"]), device, reps)
    res["copy-roofline best shape"] = ms
    out(f"{f'copy-roofline {P.BEST_TILE} x {P.THREADS} threads':52s} {ms:8.4f} ms  moves "
        f"{nbytes / 1e6:.1f} MB, {nbytes / ms / 1e6:.1f} GB/s of "
        f"{HBM_BYTES_PER_S / 1e9:.0f}  [{label}]")
    return res


def main(argv=None):
    a = parse_args(sys.argv[1:] if argv is None else argv, n=120, reps=30)
    run(setup(a["n"], a["device"]), reps=a["reps"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
