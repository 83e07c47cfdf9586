#!/usr/bin/env python3
"""Smoke run of castro_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one card and the CUDA
toolkit. In order:
  1. print the card (nvidia-smi name and power limit, torch's name, count);
  2. build the five CUDA kernels from castro_tpu_torch/csrc and print each
     kernel's registers, stack, shared memory and spills (ptxas -v);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes (3D Sedov, 128^3 interior, 136^3 grown, float32,
     on the initial state and the state after one step), and on the
     branches the main path does not take at 32^3 (HLLC, srcQ, the face
     stages terms=[], one corner and final without consup, wall masks,
     symmetry/periodic/no-slip fills, prim_aux without div u);
  4. drive the main path: Simulation(...).run() on Sedov 128^3 float32 on
     the card, with every launch count zeroed just before and read just
     after, checked against the step's structure; check mass conservation
     and that a 32^3 run on the card agrees with the same run on the CPU;
  5. time the main path (zones/s at 128^3 and 256^3, peak memory) and each
     kernel (its device time under torch.profiler) beside its bound and its
     plain version's time (CUDA events).
Any failure exits non-zero. The last two lines are the kernels' JSON and
the {"ok": true, ...} line. Without a card, or without the package beside
this file, it exits 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

# Kernel vs plain version, on the same inputs on the card. flatten,
# trace_ppm and ctu_face are built with --fmad=false and do their plain
# versions' operations in the same order: they must agree bit for bit.
# prim_aux and clean_fill divide k_B/m_u by mu (gamma-1) for the EOS's cv,
# where torch computes a scalar over a tensor as a reciprocal times the
# scalar, one rounding more; they are held pointwise to RTOL |plain| with no
# absolute term, except div u, a sum of differences, whose floor is RTOL
# times its largest magnitude. Card vs CPU after three steps: RTOL |cpu|
# plus RTOL times each component's largest magnitude, as the float64 tests
# against JAX scale their floor (tests/test_torch_sedov.py). RTOL is the
# fused-vs-XLA float32 budget of the JAX package (tests/test_pallas.py:41).
EXACT = ("flatten", "trace_ppm", "ctu_face")
RTOL = 2e-5
MASS_RTOL = 1e-6
# H100 SXM, published peaks (NVIDIA's data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
N_MAIN, STEPS_MAIN = 128, 10
N_BIG, STEPS_BIG = 256, 4
N_SMALL = 32

REPLACES = {
    "prim_aux": "castro_tpu/ops/pallas_kernels.py:770",
    "flatten": "castro_tpu/ops/pallas_kernels.py:953",
    "trace_ppm": "castro_tpu/ops/pallas_kernels.py:1415",
    "ctu_face": "castro_tpu/ops/pallas_kernels.py:395",
    "clean_fill": "castro_tpu/ops/pallas_kernels.py:1019",
}
# aten operations counted as arithmetic when the plain version's operations
# are counted (count_ops); data movement (copies, cat, stack, views, fills)
# is not counted
ARITH_OPS = {
    "abs", "add", "addcdiv", "addcmul", "amax", "amin", "bitwise_and", "bitwise_not",
    "bitwise_or", "clamp", "clamp_max", "clamp_min", "div", "eq", "exp", "floor", "fmax",
    "fmin", "ge", "gt", "isfinite", "isinf", "isnan", "le", "log", "logical_and",
    "logical_not", "logical_or", "lt", "max", "maximum", "min", "minimum", "mul", "ne",
    "neg", "pow", "reciprocal", "rsqrt", "rsub", "sign", "sgn", "sqrt", "sub", "sum",
    "where"}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def compare(got, ref, rtol, floor=(), report=False):
    """(max |got - ref|, max |got - ref| / |ref|, whether every element lies
    within rtol |ref|); the outputs whose indices are in `floor` (all of them
    for floor=True) also get rtol times each component's largest |ref| (the
    leading axis of a 4-D output). rtol = 0 asks for equality. With `report`,
    print the worst violation of each output."""
    import torch

    got = [got] if isinstance(got, torch.Tensor) else got
    ref = [ref] if isinstance(ref, torch.Tensor) else ref
    worst, worst_rel, ok = 0.0, 0.0, True
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.double(), r.double()
        # NaN in both at the same place (the ghost margin is garbage by
        # construction) counts as agreement
        both_nan = torch.isnan(g) & torch.isnan(r)
        d = torch.where(both_nan, 0.0, torch.nan_to_num((g - r).abs(), nan=float("inf")))
        worst = max(worst, float(d.max()))
        rel = torch.where(d == 0, 0.0, torch.nan_to_num(d / r.abs(), nan=float("inf")))
        worst_rel = max(worst_rel, float(rel.max()))
        tol = rtol * r.abs()
        if floor is True or i in floor:
            mag = torch.nan_to_num(r.abs(), nan=0.0)
            if r.dim() == 4:
                tol = tol + rtol * mag.flatten(1).amax(1).reshape(-1, 1, 1, 1)
            else:
                tol = tol + rtol * mag.max()
        excess = torch.where(both_nan, -1.0, torch.nan_to_num(d - tol, nan=1.0))
        good = bool((excess <= 0).all())
        ok = ok and good
        if report and not good:
            idx = tuple(int(v) for v in torch.unravel_index(excess.argmax(), excess.shape))
            print(f"    output {i} {tuple(g.shape)}: worst at {idx}: kernel {float(g[idx])!r} "
                  f"plain {float(r[idx])!r}; {int((excess > 0).sum())} elements outside",
                  file=sys.stderr)
    return worst, worst_rel, ok


def flat(o):
    """The tensors in a nest of tuples, lists and dicts, in order."""
    import torch

    if isinstance(o, torch.Tensor):
        return [o]
    if isinstance(o, dict):
        o = list(o.values())
    if isinstance(o, (list, tuple)):
        return [x for i in o for x in flat(i)]
    return []


def time_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps):
    """Device time of one launch of the kernel that `fn` launches, from
    torch.profiler: the mean over the launches of `reps` calls that the
    profiler recorded (it may miss one) of the ctt:: kernel alone, without
    the wrapper's allocations and fills. None if the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if "ctt::" in e.key:
            dev_us = getattr(e, "self_device_time_total", None)
            total_us += dev_us if dev_us is not None else getattr(e, "self_cuda_time_total", 0.0)
            count += e.count
    if total_us <= 0:
        return None
    if not 0 < count <= reps:
        fail(f"the profiler counted {count} kernel launches in {reps} calls")
    return total_us / count / 1e3


def count_ops(fn):
    """The arithmetic operations of one call of a plain version: each aten
    operation of ARITH_OPS counts one operation per element of its largest
    tensor operand or result (the input of a reduction, the broadcast
    output of an elementwise operation)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in ARITH_OPS:
                sizes = [t.numel() for t in flat([args, kwargs or {}, out])]
                Count.ops += max(sizes, default=0)
            return out

    with Count():
        fn()
    return Count.ops


def profile_steps(sim, steps, card):
    """Device busy time by kernel over a few steps of `sim.run`, under
    torch.profiler; the idle share is 1 - busy / wall (the profiler's own
    host overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(max_step=sim.step_count + steps, verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    if not rows:
        print(f"profile [{card}]: device time not measured (the profiler saw no device time)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile [{card}]: {steps} steps under torch.profiler, wall {wall_us / steps:.1f} "
          f"us/step, device busy {busy / steps:.1f} us/step, idle share "
          f"{1.0 - busy / wall_us:.4f}; device time by name (us/step, launches/step):")
    for dev_us, count, key in rows[:14]:
        print(f"  {dev_us / steps:10.1f}  {count / steps:5.1f}  {key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a machine with an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from castro_tpu_torch.driver.sim import Simulation
        from castro_tpu_torch.ops import kernels as K
        from castro_tpu_torch.ops.ctu import _bnd_masks
        from castro_tpu_torch.problems import sedov
    except ImportError as e:
        print(f"castro_tpu_torch not found beside chip_smoke.py: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind}, count {torch.cuda.device_count()} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    K.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source)")
    for line in K.build_log().splitlines():
        if line.startswith("== ") or "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print("  " + line.replace("ptxas info    : ", "").strip())

    def sedov_sim(n, dtype="float32", bc=2, device="cuda"):
        p = sedov.make_params(n=n, dim=3, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                              dtype=dtype)
        p = p.with_ns("castro", lo_bc=(bc,) * 3, hi_bc=(bc,) * 3)
        return Simulation(p, problem_init=sedov.problem_init, device=device)

    # -- 3. kernel vs plain --------------------------------------------------------
    errs = {name: [0.0, 0.0] for name in REPLACES}

    def check(name, got, ref, what, floor=()):
        rtol = 0.0 if name in EXACT else RTOL
        tol = "0 (bit for bit)" if name in EXACT else f"{RTOL:g}|plain|" + (
            f", div u + {RTOL:g} max|div u|" if floor else "")
        err, rel, ok = compare(flat(got), flat(ref), rtol, floor)
        errs[name] = [max(errs[name][0], err), max(errs[name][1], rel)]
        print(f"  {name:10s} {what:42s} max abs err {err:.3e} rel {rel:.3e} "
              f"(tol {tol}) {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            compare(flat(got), flat(ref), rtol, floor, report=True)
            fail(f"{name} disagrees with its plain version on {what}")

    def inputs(sim, u, dt):
        """Every kernel input of one step, made by the plain versions."""
        c, L, cfg = sim.params.castro, sim.layout, sim.cfg
        q, qaux, div = K.prim_aux_plain(u, L, sim.eos, cfg.small_dens, sim.small_temp,
                                        sim.geom.dx)
        flatn = K.flatten_plain(q, L)
        masks = _bnd_masks(u.shape[1:], 3, sim.ng, cfg.lo_bc, cfg.hi_bc)
        return dict(q=q, qaux=qaux, div=div, flatn=flatn, masks=masks, dt=dt,
                    dx=sim.geom.dx, L=L, cfg=cfg, eos=sim.eos, sim=sim, u=u,
                    eta2=c.dual_energy_eta2)

    def compare_step(x, label, solver=0, src=None, off_path=False):
        L, cfg, dt, dx = x["L"], x["cfg"], x["dt"], x["dx"]
        sim, u = x["sim"], x["u"]
        args = (u, L, x["eos"], cfg.small_dens, sim.small_temp, dx)
        check("prim_aux", K.prim_aux(*args, courant_dt=dt),
              K.prim_aux_plain(*args, courant_dt=dt), f"{label}, divu+courant", floor=(2,))
        check("flatten", K.flatten(x["q"], L), K.flatten_plain(x["q"], L), label)
        tr = []
        for d in range(3):
            fr = dict(coord=0, riemann_solver=solver, bnd_mask=x["masks"][d])
            a = (x["q"], x["qaux"], src, x["flatn"], d, dt, dx[d], L, cfg.small_dens,
                 cfg.small_pres, cfg.small_ener)
            got = K.trace_ppm(*a, fuse_riemann=fr)
            ref = K.trace_ppm_plain(*a, fuse_riemann=fr)
            check("trace_ppm", got, ref, f"{label}, d={d}")
            tr.append(ref)
        hsrc = torch.zeros_like(u)
        for d in range(3):
            t1, t2 = [t for t in range(3) if t != d]

            def term(t, f):
                return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * dt / dx[t]}

            fa = (tr[d][0], tr[d][1], x["qaux"], d)
            fb = (L, 0, solver, cfg.small_dens, cfg.small_pres, True, False)
            kw = dict(bnd_mask=x["masks"][d])
            check("ctu_face", K.ctu_face(*fa, [term(t1, 1 / 3)], *fb, terms2=[term(t2, 1 / 3)], **kw),
                  K.ctu_face_plain(*fa, [term(t1, 1 / 3)], *fb, terms2=[term(t2, 1 / 3)], **kw),
                  f"{label}, corner pair d={d}")
            cs = dict(hsrc=hsrc, div_node=x["div"], u=u, difmag=cfg.difmag, dx=dx,
                      finalize_dt=dt if d == 2 else None)
            fin = [term(t1, 0.5), term(t2, 0.5)]
            got = K.ctu_face(*fa, fin, *fb, consup=cs, **kw)
            ref = K.ctu_face_plain(*fa, fin, *fb, consup=cs, **kw)
            check("ctu_face", got, ref, f"{label}, final+consup d={d}")
            hsrc = ref[1]
            if off_path:  # the variants the main path does not launch
                for terms, kind in (([], "terms=[]"), ([term(t1, 1 / 3)], "one corner"),
                                    (fin, "final, no consup")):
                    check("ctu_face", K.ctu_face(*fa, terms, *fb, **kw),
                          K.ctu_face_plain(*fa, terms, *fb, **kw), f"{label}, {kind} d={d}")
        ca = (hsrc, L, x["eos"], cfg.lo_bc, cfg.hi_bc, sim.ng, cfg.small_dens,
              sim.small_temp, x["eta2"], True)
        check("clean_fill", K.clean_fill(*ca, with_status=True),
              K.clean_fill_plain(*ca, with_status=True), f"{label}, with status")
        check("clean_fill", K.clean_fill(*ca), K.clean_fill_plain(*ca), f"{label}, no status")

    print(f"kernel vs plain, {N_MAIN}^3 Sedov float32 (main-path shapes):", flush=True)
    sim = sedov_sim(N_MAIN)
    sim.init_data()
    dt = sim.estimate_dt()
    compare_step(inputs(sim, sim.u, dt), "Sedov init")
    sim.advance(dt)
    compare_step(inputs(sim, sim.u, dt), "after 1 step")
    del sim
    print(f"kernel vs plain, {N_SMALL}^3, branches off the main path:", flush=True)
    for bc, solver, label in ((3, 2, "symmetry walls, HLLC"), (0, 0, "periodic"),
                              (5, 0, "no-slip walls")):
        s = sedov_sim(N_SMALL, bc=bc)
        s.init_data()
        dts = s.estimate_dt()
        s.advance(dts)
        x = inputs(s, s.u, dts)
        g = torch.Generator(dev).manual_seed(0)
        src = 1e-3 * x["q"].abs() * torch.randn(x["q"].shape, device=dev, generator=g)
        compare_step(x, f"{label}, srcQ", solver=solver, src=src, off_path=True)
        args = (s.u, s.layout, s.eos, s.cfg.small_dens, s.small_temp, s.geom.dx)
        check("prim_aux", K.prim_aux(*args, with_divu=False),
              K.prim_aux_plain(*args, with_divu=False), f"{label}, no divu")
    torch.cuda.empty_cache()

    # -- 4. the main path -------------------------------------------------------------
    print(f"main path: Sedov {N_MAIN}^3 float32, Simulation.run(max_step={STEPS_MAIN}) "
          f"on the card", flush=True)
    sim = sedov_sim(N_MAIN)
    tries = {"n": 0}
    step_impl = sim._step_impl

    def counted(*a, **kw):
        tries["n"] += 1
        return step_impl(*a, **kw)

    sim._step_impl = counted
    K.reset_launch_counts()
    sim.init_data()
    mass0 = float(sim.interior()[sim.layout.URHO].double().sum())
    sim.run(max_step=STEPS_MAIN, verbose=False)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    n = tries["n"]
    expected = {"prim_aux": n, "flatten": n, "trace_ppm": 3 * n, "ctu_face": 6 * n,
                "clean_fill": 1 + n}
    print(f"  {sim.step_count} steps ({n} tried), t = {sim.t:.6e}; launches {launches}; "
          f"expected {expected}")
    if launches != expected or any(v == 0 for v in launches.values()):
        fail("the main path's launch counts do not match the step's structure")
    u_end = sim.interior()
    if not bool(torch.isfinite(u_end).all()):
        fail("non-finite state after the main path")
    mass1 = float(u_end[sim.layout.URHO].double().sum())
    dm = abs(mass1 - mass0) / mass0
    print(f"  mass: {mass0:.9e} -> {mass1:.9e}, relative change {dm:.3e} (limit {MASS_RTOL:g})")
    if dm > MASS_RTOL:
        fail("mass is not conserved on the main path")
    del sim, u_end

    print(f"card vs CPU, Sedov {N_SMALL}^3 float32, 3 steps (CPU through the plain versions):",
          flush=True)
    runs, dts = {}, []
    for where in ("cpu", "cuda"):
        s = sedov_sim(N_SMALL, device=where)
        s.init_data()
        if where == "cpu":
            s.run(max_step=3, verbose=False, callbacks=[lambda s_: dts.append(s_.dt)])
        else:  # the same dt sequence on the card
            for d_ in dts:
                s.advance(d_)
        runs[where] = s.interior().cpu()
    err, rel, ok = compare(runs["cuda"], runs["cpu"], RTOL, floor=True)
    print(f"  max abs err {err:.3e} rel {rel:.3e} (tol {RTOL:g}|cpu| + {RTOL:g} max|cpu| "
          f"per component) {'ok' if ok else 'DISAGREES'}")
    if not ok:
        compare(runs["cuda"], runs["cpu"], RTOL, floor=True, report=True)
        fail("the card and the CPU disagree on the 32^3 run")

    # -- 5. timing ---------------------------------------------------------------------
    results = {}
    for n_cells, steps in ((N_MAIN, STEPS_MAIN), (N_BIG, STEPS_BIG)):
        s = sedov_sim(n_cells)
        s.init_data()
        s.run(max_step=2, verbose=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s.run(max_step=2 + steps, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        zps = steps * n_cells ** 3 / wall
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[n_cells] = dict(zones_per_s=zps, step_ms=1e3 * wall / steps, peak_gib=peak)
        print(f"main path timing [{card}]: Sedov {n_cells}^3 float32, {steps} steps "
              f"(estimate_dt + advance): {1e3 * wall / steps:.3f} ms/step, {zps:.6e} zones/s, "
              f"peak memory {peak:.3f} GiB", flush=True)
        if n_cells == N_MAIN:
            profile_steps(s, 3, card)
        del s
        torch.cuda.empty_cache()

    sim = sedov_sim(N_MAIN)
    sim.init_data()
    dt = sim.estimate_dt()
    sim.advance(dt)
    x = inputs(sim, sim.u, dt)
    L, cfg, dx, u = x["L"], x["cfg"], x["dx"], sim.u
    S = u[0].numel()
    isz = u.element_size()
    tr = [K.trace_ppm_plain(x["q"], x["qaux"], None, x["flatn"], d, dt, dx[d], L,
                            cfg.small_dens, cfg.small_pres, cfg.small_ener,
                            fuse_riemann=dict(coord=0, riemann_solver=0, bnd_mask=None))
          for d in range(3)]

    def term(t, f):
        return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * dt / dx[t]}

    fb = (L, 0, 0, cfg.small_dens, cfg.small_pres, True, False)
    hsrc = torch.zeros_like(u)
    calls = {}  # name -> list of (kernel call, plain call, components moved)
    a = (u, L, x["eos"], cfg.small_dens, sim.small_temp, dx)
    calls["prim_aux"] = [(lambda: K.prim_aux(*a, courant_dt=dt),
                          lambda: K.prim_aux_plain(*a, courant_dt=dt),
                          L.NVAR + L.NQ + L.NQAUX + 1)]
    calls["flatten"] = [(lambda: K.flatten(x["q"], L), lambda: K.flatten_plain(x["q"], L), 5)]
    calls["trace_ppm"] = []
    calls["ctu_face"] = []
    for d in range(3):
        ta = (x["q"], x["qaux"], None, x["flatn"], d, dt, dx[d], L, cfg.small_dens,
              cfg.small_pres, cfg.small_ener)
        fr = dict(coord=0, riemann_solver=0, bnd_mask=None)
        calls["trace_ppm"].append((lambda ta=ta, fr=fr: K.trace_ppm(*ta, fuse_riemann=fr),
                                   lambda ta=ta, fr=fr: K.trace_ppm_plain(*ta, fuse_riemann=fr),
                                   L.NQ + 2 + 1 + 2 * L.NQ + L.NVAR + L.NGDNV))
    for d in range(3):
        t1, t2 = [t for t in range(3) if t != d]
        fa = (tr[d][0], tr[d][1], x["qaux"], d)
        p1, p2 = [term(t1, 1 / 3)], [term(t2, 1 / 3)]
        calls["ctu_face"].append((
            lambda fa=fa, p1=p1, p2=p2: K.ctu_face(*fa, p1, *fb, terms2=p2),
            lambda fa=fa, p1=p1, p2=p2: K.ctu_face_plain(*fa, p1, *fb, terms2=p2),
            2 * L.NQ + 2 + 2 * (L.NVAR + 2) + 2 * (L.NVAR + L.NGDNV)))
    for d in range(3):
        t1, t2 = [t for t in range(3) if t != d]
        fa = (tr[d][0], tr[d][1], x["qaux"], d)
        fin = [term(t1, 0.5), term(t2, 0.5)]
        cs = dict(hsrc=hsrc, div_node=x["div"], u=u, difmag=cfg.difmag, dx=dx,
                  finalize_dt=dt if d == 2 else None)
        calls["ctu_face"].append((
            lambda fa=fa, fin=fin, cs=cs: K.ctu_face(*fa, fin, *fb, consup=cs),
            lambda fa=fa, fin=fin, cs=cs: K.ctu_face_plain(*fa, fin, *fb, consup=cs),
            2 * L.NQ + 2 + 2 * (L.NVAR + 2) + 2 * L.NVAR + 1 + L.NVAR + L.NVAR + L.NGDNV))
    ca = (u, L, x["eos"], cfg.lo_bc, cfg.hi_bc, sim.ng, cfg.small_dens, sim.small_temp,
          x["eta2"], True)
    calls["clean_fill"] = [(lambda: K.clean_fill(*ca, with_status=True),
                            lambda: K.clean_fill_plain(*ca, with_status=True), 2 * L.NVAR)]

    entries = []
    print(f"kernel timing [{card}], Sedov {N_MAIN}^3 float32 (grown {u.shape[1]}^3), per "
          f"launch: the kernel's device time (torch.profiler), the wrapper's and the plain "
          f"version's time (CUDA events); bound = max(bytes / {HBM_BYTES_PER_S:g} B/s, "
          f"operations of the plain version / {FP32_OPS_PER_S:g} op/s):", flush=True)
    for name, variants in calls.items():
        sums = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                    ops_ms=0.0)
        for kern, plain, comps in variants:
            w_ms = time_ms(kern, reps=20)
            k_ms = kernel_device_ms(kern, reps=20)
            if k_ms is None:
                print(f"  {name}: the profiler saw no device time; ms is the wrapper's time")
                k_ms = w_ms
            p_ms = time_ms(plain, reps=3, warm=1)
            ops = count_ops(plain)
            b_bytes = comps * S * isz / HBM_BYTES_PER_S * 1e3
            b_ops = ops / FP32_OPS_PER_S * 1e3
            print(f"  {name:10s} {k_ms:9.4f} ms   wrapper {w_ms:9.4f} ms   plain {p_ms:9.4f} ms"
                  f"   bound {max(b_bytes, b_ops):.4f} ms ({comps} components, {b_bytes:.4f} ms;"
                  f" {ops / S:.1f} operations a cell, {b_ops:.4f} ms)", flush=True)
            for key, v in (("ms", k_ms), ("wrapper_ms", w_ms), ("plain_ms", p_ms),
                           ("bound_ms", max(b_bytes, b_ops)), ("bytes_ms", b_bytes),
                           ("ops_ms", b_ops)):
                sums[key] += v / len(variants)
        entries.append({
            "name": name, "route": "cuda", "source": f"castro_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1], "ms": sums["ms"],
            "wrapper_ms": sums["wrapper_ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"],
            "bound_by": "bytes" if sums["bytes_ms"] >= sums["ops_ms"] else "operations",
            "library_ms": None})
    step_bound = sum(e["bound_ms"] * expected[e["name"]] / n for e in entries
                     if e["name"] != "clean_fill") + entries[-1]["bound_ms"]
    print(f"summary [{card}]: " + json.dumps({
        "zones_per_s": {str(k): v["zones_per_s"] for k, v in results.items()},
        "step_ms": {str(k): v["step_ms"] for k, v in results.items()},
        "peak_gib": {str(k): v["peak_gib"] for k, v in results.items()},
        "step_bound_ms_128": step_bound}))
    print(smi_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
