"""The vector-unit throughput probe.

    python -m castro_tpu_torch.scripts.prof_vpu [n=512] [device=cpu]

Counterpart of `scripts/prof_vpu.py`: x = 1.1 on an [n, n] float32 array,
one body iterated per element (fma-shaped x*1.0000001+1e-9, its fused
__fmaf_rn form, 1/(x+1e-9), rsqrt(x)+1, the approximate reciprocal +1e-9,
exp(x*1e-9)). The time of one iteration is the best of 3 launches at 60000
iterations minus the best of 3 at 10000, over n^2 * 50000 element-ops; on
the card each op's picoseconds stand beside its bound from the published
rate of compute capability 9.0 (128 FP32 and 16 MUFU instructions a clock
on each SM, `nvidia-smi`'s maximum SM clock, the device's SM count) and the
pipe that bounds it: FP32 for fma (two instructions, FMUL and FADD) and
fma_rn (one FFMA), MUFU for div, rsqrt, recip_approx and exp. On the
CPU (device=cpu) the plain versions run, at the iteration counts
`lo=`/`hi=` (default 10/60), and the times are the CPU's.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from castro_tpu_torch.ops import probes as P
from castro_tpu_torch.scripts.common import card_label, parse_args, time_once_ms

# minimal instructions a body needs per element and iteration: (FP32, MUFU)
INSTRUCTIONS = {"fma": (2, 0), "fma_rn": (1, 0), "div": (1, 1), "rsqrt": (1, 1),
                "recip_approx": (1, 1), "exp": (1, 1)}
FP32_PER_CLOCK_SM, MUFU_PER_CLOCK_SM = 128, 16


def pipe(op):
    """The pipe whose rate bounds a body: FP32 or MUFU."""
    fp32, mufu = INSTRUCTIONS[op]
    return "FP32" if fp32 / FP32_PER_CLOCK_SM >= mufu / MUFU_PER_CLOCK_SM else "MUFU"


def bound_ps(op, sms, clock_hz):
    """The least time of one element-op at the published instruction rates."""
    fp32, mufu = INSTRUCTIONS[op]
    return 1e12 * max(fp32 / FP32_PER_CLOCK_SM, mufu / MUFU_PER_CLOCK_SM) / (sms * clock_hz)


def max_sm_clock_hz():
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def per_op_ps(x, op, lo, hi):
    """(best of 3 at hi iterations - best of 3 at lo) / (elements * (hi - lo))."""
    def best(iters):
        return min(time_once_ms(lambda: P.probe_vpu(x, op, iters), x.device)
                   for _ in range(3))

    P.probe_vpu(x, op, lo)  # warm-up
    d_ms = best(hi) - best(lo)
    return 1e9 * d_ms / (x.numel() * (hi - lo))


def run(x, lo=10000, hi=60000, out=print):
    """{op: ps per element-op}, each printed with its bound on the card."""
    label = card_label(x.device)
    bounds = None
    if x.device.type == "cuda":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        clock = max_sm_clock_hz()
        bounds = {op: bound_ps(op, sms, clock) for op in P.VPU_OPS}
    res = {}
    for op in P.VPU_OPS:
        ps = per_op_ps(x, op, lo, hi)
        res[op] = ps
        line = f"{op}: {1.0 / ps:.2f} Telem-iter/s -> per-elem-op {ps:.4f} ps"
        if bounds is not None:
            line += f" (bound {bounds[op]:.4f} ps, {pipe(op)} pipe, {bounds[op] / ps:.3f} of it)"
        out(f"{line}  [{label}]")
    return res, bounds


def main(argv=None):
    a = parse_args(sys.argv[1:] if argv is None else argv, n=512, lo=-1, hi=-1)
    cuda = a["device"].type == "cuda"
    lo = a["lo"] if a["lo"] > 0 else (10000 if cuda else 10)
    hi = a["hi"] if a["hi"] > 0 else (60000 if cuda else 60)
    x = torch.full((a["n"], a["n"]), 1.1, dtype=torch.float32, device=a["device"])
    run(x, lo, hi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
