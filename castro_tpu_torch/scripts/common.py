"""What the profiling entry points share: argument parsing, the card's
name and power limit, and CUDA-event timing."""

from __future__ import annotations

import subprocess
import time

import torch

from castro_tpu_torch.geometry import resolve_device


def parse_args(argv, **defaults):
    """key=value arguments over `defaults` (each converted to its default's
    type; `device` stays a string, None meaning the card)."""
    out = dict(defaults, device=None)
    for a in argv:
        key, _, val = a.partition("=")
        if key not in out:
            raise SystemExit(f"unknown argument {a!r} (have {sorted(out)})")
        default = out[key]
        out[key] = val if default is None else type(default)(val)
    out["device"] = resolve_device(out["device"])
    return out


def card_label(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card, or a label
    that says the numbers beside it are the CPU's."""
    if device.type != "cuda":
        return "CPU, plain versions; not a device measurement"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def time_once_ms(fn, device):
    """One call of `fn`: CUDA events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def mean_ms(fn, device, reps, warm=1):
    """Mean time of `reps` calls after `warm` calls."""
    for _ in range(warm):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def kernel_ms(fn, reps):
    """Device time of one launch of the CUDA kernel that `fn` launches (the
    median over `reps` calls of what torch.profiler records for the ctt::
    kernel alone, without the wrapper's allocations); None off the card or
    when the profiler records no such launch."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
          for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "ctt::" in e.name]
    us = [t for t in us if t > 0]
    return statistics.median(us) / 1e3 if us else None
