"""The three profiling probes: their wrappers and plain PyTorch versions.

Counterparts of the TPU kernels of `scripts/prof_cmpflx.py` (`make_cmpflx`,
the Riemann block at six VMEM tilings; `make_copy`, the copy roofline probe)
and `scripts/prof_vpu.py` (`make`, the vector-unit throughput probe), in
`csrc/prof_cmpflx.cu` and `csrc/prof_vpu.cu`. The entry points that time
them are `castro_tpu_torch/scripts/prof_cmpflx.py` and `prof_vpu.py`.

As for the kernels of `ops/kernels.py`: on a CPU tensor a wrapper runs its
plain version; on a CUDA tensor it checks its inputs, launches its kernel
and adds one to its `launches` count, or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.ops import kernels as K

# the TPU tilings of scripts/prof_cmpflx.py, (x, y) cells of a block with z
# whole; None along y is a row tiling (the whole y extent)
TPU_TILINGS = {"(16,16)": (16, 16), "(8,8)": (8, 8), "(32,32)": (32, 32),
               "(8,) row": (8, None), "(16,) row": (16, None), "(4,) row": (4, None)}
# threads a block; one cell a thread at a z extent of 128, the shape found
# best on the card (PERF.md), is the tile (1, 2)
THREADS = 256
BEST_TILE = (1, 2)

VPU_OPS = ("fma", "fma_rn", "div", "rsqrt", "recip_approx", "exp")
VPU_C1, VPU_C2 = 1.0000001, 1e-9


def _launch_shape(qm, tile, threads):
    g = tuple(qm.shape[1:])
    if len(g) != 3:
        raise ValueError(f"the probes take a 3D grid, not {len(g)}D")
    tx, ty = tile
    return g, int(tx), int(g[1] if ty is None else ty), int(threads)


# -- 10. probe_cmpflx -------------------------------------------------------------

def probe_cmpflx_plain(qm, qp, gl, gr, cl, cr, layout, coord, small_dens, small_pres):
    """The Riemann solve (riemannus) and flux of direction 0 on every face,
    as `_riemann_block(..., d=0, solver 0)` computes it."""
    return K.cmpflx_plain(qm, qp, gl, gr, cl, cr, 0, layout, coord, 0, small_dens,
                          small_pres)


def probe_cmpflx(qm, qp, gl, gr, cl, cr, layout, coord, small_dens, small_pres,
                 tile=BEST_TILE, threads=THREADS):
    """`probe_cmpflx_plain` with the cells of a thread block given as the
    tile (tx, ty) over (x, y), whole along z (ty None: a row tiling), dealt
    to `threads` threads: (flux [NVAR], qe [NGDNV])."""
    if not K._on_cuda(qm, qp, gl, gr, cl, cr):
        return probe_cmpflx_plain(qm, qp, gl, gr, cl, cr, layout, coord, small_dens,
                                  small_pres)
    L = layout
    K.check_kernel_layout(L)
    g, tx, ty, threads = _launch_shape(qm, tile, threads)
    dt_ = qm.dtype
    K._check(qm, "qm", dt_, (L.NQ,) + g)
    K._check(qp, "qp", dt_, (L.NQ,) + g)
    for name, t in (("gl", gl), ("gr", gr), ("cl", cl), ("cr", cr)):
        K._check(t, name, dt_, g)
    flux = torch.empty((L.NVAR,) + g, dtype=dt_, device=qm.device)
    qe = torch.empty((L.NGDNV,) + g, dtype=dt_, device=qm.device)
    K._call("probe_cmpflx", qm, qm.data_ptr(), qp.data_ptr(), gl.data_ptr(), gr.data_ptr(),
            cl.data_ptr(), cr.data_ptr(), flux.data_ptr(), qe.data_ptr(), K._ints(*g),
            L.nspec + L.naux, tx, ty, threads, K._coord(coord),
            float(K.wt(small_dens, dt_)), float(K.wt(small_pres, dt_)), K._stream(qm))
    probe_cmpflx.launches += 1
    return flux, qe


probe_cmpflx.launches = 0


# -- 11. probe_copy ----------------------------------------------------------------

def probe_copy_plain(qm, qp, layout):
    return qm[:layout.NVAR] + qp[:layout.NVAR], qm[:layout.NGDNV] * 2.0


def probe_copy(qm, qp, layout, tile=BEST_TILE, threads=THREADS):
    """The copy roofline probe: (qm[:NVAR] + qp[:NVAR], 2 qm[:NGDNV]),
    with the block tiling of `probe_cmpflx`."""
    if not K._on_cuda(qm, qp):
        return probe_copy_plain(qm, qp, layout)
    L = layout
    K.check_kernel_layout(L)
    g, tx, ty, threads = _launch_shape(qm, tile, threads)
    K._check(qm, "qm", qm.dtype, (L.NQ,) + g)
    K._check(qp, "qp", qm.dtype, (L.NQ,) + g)
    flux = torch.empty((L.NVAR,) + g, dtype=qm.dtype, device=qm.device)
    qe = torch.empty((L.NGDNV,) + g, dtype=qm.dtype, device=qm.device)
    K._call("probe_copy", qm, qm.data_ptr(), qp.data_ptr(), flux.data_ptr(), qe.data_ptr(),
            K._ints(*g), L.nspec + L.naux, tx, ty, threads, K._stream(qm))
    probe_copy.launches += 1
    return flux, qe


probe_copy.launches = 0


# -- 12. probe_vpu -----------------------------------------------------------------

def vpu_body(op):
    """The plain body of one vpu op, x -> x' (float32 tensors)."""
    return {
        "fma": lambda x: x * VPU_C1 + VPU_C2,
        "fma_rn": lambda x: x * VPU_C1 + VPU_C2,
        "div": lambda x: 1.0 / (x + VPU_C2),
        "rsqrt": lambda x: torch.rsqrt(x) + 1.0,
        "recip_approx": lambda x: torch.reciprocal(x) + VPU_C2,
        "exp": lambda x: torch.exp(x * VPU_C2),
    }[op]


def probe_vpu_plain(x, op, iters):
    body = vpu_body(op)
    for _ in range(iters):
        x = body(x)
    return x


def probe_vpu(x, op, iters):
    """x [any shape, float32] with the body `op` (one of VPU_OPS) applied
    `iters` times to every element. fma_rn is one fused multiply-add, its
    plain version a multiply and an add; recip_approx is the approximate
    reciprocal, its plain version the IEEE one."""
    if op not in VPU_OPS:
        raise ValueError(f"unknown vpu op {op!r} (have {VPU_OPS})")
    if not K._on_cuda(x):
        return probe_vpu_plain(x, op, iters)
    K._check(x, "x", torch.float32, tuple(x.shape))
    out = torch.empty_like(x)
    K._call("probe_vpu", x, x.data_ptr(), out.data_ptr(), x.numel(), VPU_OPS.index(op),
            int(iters), float(np.float32(VPU_C1)), float(np.float32(VPU_C2)), K._stream(x))
    probe_vpu.launches += 1
    return out


probe_vpu.launches = 0

PROBES = (probe_cmpflx, probe_copy, probe_vpu)
