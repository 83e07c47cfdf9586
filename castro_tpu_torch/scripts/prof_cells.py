"""Times of the two cell kernels, prim_aux and flatten, and their outputs
held against another build's.

    python -m castro_tpu_torch.scripts.prof_cells [sizes=128,256] [reps=50]
        [steps=0] [save=PATH] [against=PATH] [device=cpu]

For each n in `sizes`, from the 3D Sedov state of bench.py (n^3 interior,
float32; r_init 0.1, exp_energy 0.5, outflow) one step after init, it
times prim_aux as the fused step calls it (div u and the Courant maximum)
and flatten on the plain version's q: the mean of `reps` back-to-back
calls of the wrapper (CUDA events) and the kernel's own device time (the
median of what torch.profiler records over `reps` calls), beside its
byte bound: each input component it reads once and each output written
once at 3.35 TB/s.
Every line carries the card's name and power limit.

With steps=N it also times the fused step itself at each size, as
chip_smoke.py times path A: N steps of Simulation.run (estimate_dt +
advance, host syncs included) after two warm-up steps, in ms a step and
zones a second.

save=PATH writes, with torch.save, two states and both kernels' outputs on
them: the Sedov state of the first size after one step, and the Sedov
state on 29 x 21 x 37 interior cells (37 x 29 x 45 grown, prime extents)
with symmetry walls after one step. against=PATH runs this build's kernels
on the states the file holds and exits non-zero unless every output
equals the file's bit for bit. Run save= in one tree and against= in the
other to compare two commits' kernels in one call. On the card unless
device=cpu, where the plain versions run and the times are the CPU's.
"""

from __future__ import annotations

import sys

import torch

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.problems import sedov
from castro_tpu_torch.scripts.common import (card_label, kernel_ms, mean_ms, parse_args,
                                              time_once_ms)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
RAGGED = (29, 21, 37)  # interior cells of the ragged state


def setup(n=128, device=None, n_cell=None, bc=2):
    """The Sedov state one step after init and what the two kernels take:
    dict(u, q (the plain version's), layout, eos, small_dens, small_temp,
    dx, dt)."""
    params = sedov.make_params(n=n, dim=3, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                               dtype="float32")
    params = params.with_ns("castro", lo_bc=(bc,) * 3, hi_bc=(bc,) * 3)
    if n_cell is not None:
        params = params.with_ns("amr", n_cell=n_cell)
    sim = Simulation(params, problem_init=sedov.problem_init, device=device)
    sim.init_data()
    dt = sim.estimate_dt()
    sim.advance(dt)
    x = dict(u=sim.u, layout=sim.layout, eos=sim.eos, small_dens=sim.cfg.small_dens,
             small_temp=sim.small_temp, dx=sim.geom.dx, dt=dt)
    x["q"] = K.prim_aux_plain(*_prim_args(x))[0]
    return x


def _prim_args(x):
    return x["u"], x["layout"], x["eos"], x["small_dens"], x["small_temp"], x["dx"]


def calls(x):
    """[(kernel, kernel call, plain call, components moved a cell)] at the
    inputs `x`: prim_aux reads six of u's components (not the total energy
    or the temperature) and writes q, qaux and div; flatten reads p and
    three velocities and writes flatn."""
    L, a, dt = x["layout"], _prim_args(x), x["dt"]
    return [("prim_aux", lambda: K.prim_aux(*a, courant_dt=dt),
             lambda: K.prim_aux_plain(*a, courant_dt=dt), L.NVAR - 2 + L.NQ + L.NQAUX + 1),
            ("flatten", lambda: K.flatten(x["q"], L), lambda: K.flatten_plain(x["q"], L), 5)]


def bound_ms(x, comps):
    """The byte bound of a kernel that moves `comps` components a cell."""
    u = x["u"]
    return comps * u[0].numel() * u.element_size() / HBM_BYTES_PER_S * 1e3


def run(x, reps=50, out=print):
    """Time both kernels; returns {kernel: ms}."""
    device = x["u"].device
    label = card_label(device)
    grown = " x ".join(str(s) for s in x["u"].shape[1:])
    res = {}
    for name, kern, _, comps in calls(x):
        ms = mean_ms(kern, device, reps)
        dev_ms = kernel_ms(kern, reps) if device.type == "cuda" else None
        res[name] = ms
        kernel = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        out(f"{name:8s} {grown} wrapper {ms:8.4f} ms  kernel {kernel}  bound "
            f"{bound_ms(x, comps):.4f} ms ({comps} components a cell)  [{label}]")
    return res


def time_path(n, steps, device=None, out=print):
    """Path A at n^3: (ms a step, zones a second) of `steps` steps of
    Simulation.run after two warm-up steps."""
    params = sedov.make_params(n=n, dim=3, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                               dtype="float32")
    sim = Simulation(params, problem_init=sedov.problem_init, device=device)
    sim.init_data()
    sim.run(max_step=2, verbose=False)
    zones0 = sim.num_zones_advanced
    ms = time_once_ms(lambda: sim.run(max_step=2 + steps, verbose=False), sim.u.device)
    zps = (sim.num_zones_advanced - zones0) / (ms / 1e3)
    out(f"path A   {n}^3 {steps} steps  {ms / steps:8.3f} ms a step  {zps:.6e} zones/s  "
        f"[{card_label(sim.u.device)}]")
    return ms / steps, zps


def outputs(x):
    """Both kernels' outputs on `x`: prim_aux's q, qaux, div and Courant
    maximum, and flatn."""
    q, qaux, div, cou = K.prim_aux(*_prim_args(x), courant_dt=x["dt"])
    return [q, qaux, div, cou, K.flatten(x["q"], x["layout"])]


OUTPUT_NAMES = ("q", "qaux", "div", "courant", "flatn")


def states(n, device=None):
    """{label: inputs} of the two states save= writes."""
    return {f"sedov {n}^3": setup(n, device),
            "ragged, walls": setup(RAGGED[0], device, n_cell=RAGGED, bc=3)}


def save(path, n, device=None):
    """torch.save {label: {"inputs": what the kernels take, "outputs": ...}}."""
    rec = {}
    for label, x in states(n, device).items():
        rec[label] = {"inputs": {k: x[k] for k in ("u", "q", "dx", "dt", "small_dens",
                                                  "small_temp")},
                      "outputs": [t.cpu() for t in outputs(x)]}
    torch.save(rec, path)
    return rec


def against(path, device=None, out=print):
    """This build's outputs on the states in `path` against the file's;
    returns the number of outputs that differ anywhere."""
    rec = torch.load(path)
    like = setup(8, device)  # the layout and EOS, as save() had them
    bad = 0
    for label, r in rec.items():
        x = dict(like, **{k: v.to(like["u"].device) if torch.is_tensor(v) else v
                          for k, v in r["inputs"].items()})
        for name, got, ref in zip(OUTPUT_NAMES, outputs(x), r["outputs"]):
            got = got.cpu()
            same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
            same &= torch.signbit(got) == torch.signbit(ref)
            ndiff = int((~same).sum())
            bad += ndiff > 0
            out(f"{label:14s} {name:8s} {'bit for bit' if ndiff == 0 else f'{ndiff} differ'} "
                f"(max abs {float((got - ref).abs().nan_to_num().max()):.3e})")
    return bad


def main(argv=None):
    a = parse_args(sys.argv[1:] if argv is None else argv, sizes="128,256", reps=50,
                   steps=0, save="", against="")
    sizes = [int(s) for s in a["sizes"].split(",")]
    for n in sizes:
        run(setup(n, a["device"]), reps=a["reps"])
        if a["steps"]:
            time_path(n, a["steps"], a["device"])
    if a["save"]:
        save(a["save"], sizes[0], a["device"])
    if a["against"]:
        return 1 if against(a["against"], a["device"]) else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
