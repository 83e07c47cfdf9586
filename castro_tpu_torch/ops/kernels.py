"""The hand-written CUDA kernels of the CTU step, their wrappers, and the
plain PyTorch version of each.

Counterpart of `castro_tpu/ops/pallas_kernels.py`. Nine kernels, one
source each under `castro_tpu_torch/csrc/` (the library also holds the
three profiling probes of `ops/probes.py`, `prof_cmpflx.cu` and
`prof_vpu.cu`):

  prim_aux      ctoprim + node div u + whole-grid Courant max  (prim_aux.cu)
  flatten       Miller-Colella flattening, 3 directions + min    (flatten.cu)
  trace_ppm     PPM trace of one direction [+ 1D Riemann + flux] (trace_ppm.cu)
  ctu_face      one CTU face stage [paired | + consup]           (ctu_face.cu)
  clean_fill    clean_state + ghost fill [+ status]              (clean_fill.cu)
  cmpflx        pointwise Riemann solve + flux, 1D/2D/3D         (cmpflx.cu)
  trans_apply   transverse apply on a summed bundle, 2D/3D       (trans_apply.cu)
  trans_cmpflx  trans_apply of both states + cmpflx, one pass    (trans_cmpflx.cu)
  consup        one direction's conservative update, 3D          (consup.cu)

The first five and consup are 3D; the three pointwise kernels take a grid
of any dimension and any layout the port has but MHD's: the radiation
layout of the operator-split radiation step too, whose passives lie past
QPTOT, QREITOT and each group's Er and whose Godunov state carries each
group's flux limiter and Er (written as zeros, as the plain versions
write them).

Each wrapper takes the JAX function's arguments and returns what it
returns. On a CPU tensor it runs its plain version (`*_plain`, composed from
the ported modules); on a CUDA tensor it checks device, dtype, shape and
contiguity, launches its kernel on the current stream and adds one to its
`launches` count, or raises. Nothing falls back from the card to the plain
version.

The kernels are compiled with nvcc for sm_90a at first use into
`castro_tpu_torch/_build/<hash of the sources>/`, one nvcc per source run
together, linked into one shared library with a plain C interface and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from castro_tpu_torch.driver.clean import clean_and_fill
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops.fill import WALLS
from castro_tpu_torch.ops.flatten import DZCUT, SHKTST, ZCUT1, small_pressure, uflatten
from castro_tpu_torch.ops.riemann import cmpflx as cmpflx_qaux
from castro_tpu_torch.ops.riemann import compute_flux, riemann_inputs, solve
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trace_ppm import trace_ppm as trace_ppm_xla
from castro_tpu_torch.ops.trans import term_bundle, trans_apply_bundle

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("prim_aux.cu", "flatten.cu", "trace_ppm.cu", "ctu_face.cu", "clean_fill.cu",
           "cmpflx.cu", "trans_apply.cu", "trans_cmpflx.cu", "consup.cu", "prof_cmpflx.cu",
           "prof_vpu.cu")
# --fmad=false: no multiply-add contraction, so each operation rounds as
# the plain version's does. The kernels are bound by bytes, and at the
# sharp edge of a Sedov blast the trace cancels O(100) terms down to
# O(1e-5) values, where contraction alone moved results by 1e-4
# (measured on an H100, f32 at 128^3), outside the float32 budget of 2e-5.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# -- build and load ------------------------------------------------------------

class _Library:
    """The loaded kernel library and its build log."""

    def __init__(self):
        self.lib = None
        self.build_log = ""
        self.path = None


_LIB = _Library()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source state has not been built yet)
    and return the shared library's path. Raises on any compiler error."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libcastro_kernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src} (rc {p.returncode})\n{text}")
            if p.returncode != 0:
                failed.append(src)
        (tmp / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        objs = [str(tmp / (Path(s).stem + ".o")) for s in SOURCES]
        link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                               "-o", str(tmp / lib.name), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}\n{link.stderr}")
        try:
            os.replace(tmp, out_dir)
        except OSError:  # another process finished the same build first
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return lib


_VP, _INT, _DBL, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "prim_aux": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _DBL, _DBL, _VP, _VP,
                 _VP],
    "flatten": [_VP, _VP, _VP, _INT, _INT, _VP, _VP],
    "trace_ppm": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP,
                  _INT, _INT, _INT, _VP],
    "ctu_face": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _VP, _VP, _VP, _VP,
                 _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                 _INT, _INT, _DBL, _DBL, _VP],
    "clean_fill": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _INT, _VP, _VP,
                   _INT, _VP],
    "cmpflx": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
               _INT, _DBL, _DBL, _VP],
    "trans_apply": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _DBL, _VP],
    "trans_cmpflx": [_VP] * 14 + [_VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                  _DBL, _DBL, _VP],
    "consup": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _INT, _VP],
    # the profiling probes (ops/probes.py)
    "probe_cmpflx": [_VP] * 8 + [_VP, _INT, _INT, _INT, _INT, _INT, _DBL, _DBL, _VP],
    "probe_copy": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
    "probe_vpu": [_VP, _VP, _LL, _INT, _INT, _DBL, _DBL, _VP],
}
# kernels built for float32 alone
_F32_ONLY = ("probe_vpu",)


def library():
    """The loaded kernel library (built on first use)."""
    if _LIB.lib is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            for suffix in ("f32",) if name in _F32_ONLY else ("f32", "f64"):
                fn = getattr(lib, f"ctt_{name}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        _LIB.lib = lib
        _LIB.path = path
        log = path.parent / "build.log"
        _LIB.build_log = log.read_text() if log.exists() else ""
    return _LIB.lib


def build_log() -> str:
    library()
    return _LIB.build_log


def _fn(name, dtype):
    return getattr(library(), f"ctt_{name}_{'f64' if dtype == torch.float64 else 'f32'}")


def _call(name, like, *args):
    """Launch kernel `name` for tensor `like`'s dtype on its device; raise if
    the launch returned an error."""
    with torch.cuda.device(like.device):
        rc = _fn(name, like.dtype)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


# -- argument checks -----------------------------------------------------------

def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def _check(t, name, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype} (float32/float64)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_kernel_layout(layout, dims=(3,), radiation=False):
    """Raise NotImplementedError unless a kernel that takes grids of the
    dimensions `dims` covers this layout: any number of species and aux
    components, the shock flag and hybrid momenta, not MHD, and a radiation
    layout only for the kernels that take one (`radiation`: cmpflx,
    trans_apply and trans_cmpflx, the pointwise solves of the
    operator-split radiation step)."""
    L = layout
    if L.dim not in dims:
        raise NotImplementedError(
            f"this CUDA kernel takes {'/'.join(f'{k}D' for k in dims)} grids, not {L.dim}D "
            "(ROADMAP.md, queue 2, kernel coverage)")
    if L.mhd:
        raise NotImplementedError(
            "the CUDA kernels carry no magnetic components: the MHD step is torch ops "
            "(mhd/solver.py), as the JAX package's is XLA")
    if L.radiation and not radiation:
        raise NotImplementedError(
            "this CUDA kernel carries no radiation components: 3D operator-split radiation "
            "through the CTU kernels (queue 1 item 9, ROADMAP.md)")
    if L.nspec < 1:
        raise NotImplementedError("the CUDA kernels need at least one species")


def check_kernel_eos(eos, layout):
    """Raise unless the kernels can evaluate this EOS in-kernel (prim_aux
    and clean_fill; `driver/sim.py` sends any other EOS to the torch ops,
    as the JAX package sends it to XLA)."""
    if not getattr(eos, "pallas_safe", False) or not hasattr(eos, "species_coefficients"):
        raise NotImplementedError(
            "prim_aux and clean_fill evaluate the gamma-law EOS in-kernel; another EOS takes "
            "the torch ops (driver/sim.py)")
    if len(eos.species_coefficients()[1]) != layout.nspec:
        raise ValueError("EOS species do not match the layout")


def _layout_args(layout):
    """The layout the kernels take at run time: the first passive conserved
    component, species, passives (species + aux), the shock flag's
    component (-1 without it), then the first passive primitive component
    and the Godunov component count (csrc/common.cuh:QLayout; past the
    hydro layout's on a radiation layout)."""
    L = layout
    return _ints(L.UFS, L.nspec, L.nspec + L.naux, L.USHK, L.QFS, L.NGDNV)


def _eos_args(eos, layout, like):
    """The gamma-law EOS as prim_aux and clean_fill take it; its per-species
    numbers (num/A [nspec], 1/A [nspec], csrc/common.cuh:EosGL) are kept on
    the EOS, one device tensor for each device and dtype."""
    check_kernel_eos(eos, layout)
    cache = eos.__dict__.setdefault("_kernel_coef", {})
    coef = cache.get((like.device, like.dtype))
    if coef is None:
        num, aion = eos.species_coefficients()
        vals = [n / a for n, a in zip(num, aion)] + [1.0 / a for a in aion]
        coef = torch.tensor(vals, dtype=torch.float64).to(like.dtype).to(like.device)
        cache[(like.device, like.dtype)] = coef
    return (_DBL * 2)(eos.gamma, eos._KB_OVER_MU), int(eos.assume_neutral), coef


def _ints(*xs):
    return (_INT * len(xs))(*xs)


def _dbls(*xs):
    return (_DBL * len(xs))(*(float(x) for x in xs))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def wt(x, dtype):
    """A host scalar in the working precision (np.float32/np.float64), so
    that derived scalars (dt/dx, dt/2) are rounded as the JAX package's
    traced f32 scalars are."""
    return (np.float64 if dtype == torch.float64 else np.float32)(x)


def _wall_index(mask):
    return (-1, -1) if mask is None else (mask.lo, mask.hi)


def _grid3(g):
    """Grid extents padded with trailing 1s to the kernels' three axes:
    axis d of a 1D or 2D grid stays axis d, and the strides agree."""
    return _ints(*(tuple(g) + (1,) * (3 - len(g))))


# -- 1. prim_aux ---------------------------------------------------------------

def prim_aux_plain(u, layout, eos, small_dens, small_temp, dx, with_divu=True,
                   courant_dt=None):
    q, qaux = au.ctoprim(u, layout, eos, small_dens, small_temp)
    ret = [q, qaux]
    if with_divu:
        ret.append(au.divu_node(q, dx, layout))
    if courant_dt is not None:
        ret.append(torch.max(au.courant_field(q, qaux, wt(courant_dt, u.dtype), dx, layout)))
    return tuple(ret)


def prim_aux(u, layout, eos, small_dens, small_temp, dx, with_divu=True,
             courant_dt=None):
    """ctoprim (+ node div u) (+ whole-grid max Courant number for dt):
    (q, qaux[, div][, courant]) as `pallas_kernels.prim_aux_pallas`."""
    if not _on_cuda(u):
        return prim_aux_plain(u, layout, eos, small_dens, small_temp, dx,
                              with_divu, courant_dt)
    L = layout
    check_kernel_layout(L)
    g = tuple(u.shape[1:])
    _check(u, "u", u.dtype, (L.NVAR,) + g)
    eos_d, neutral, coef = _eos_args(eos, L, u)
    q = torch.empty((L.NQ,) + g, dtype=u.dtype, device=u.device)
    qaux = torch.empty((L.NQAUX,) + g, dtype=u.dtype, device=u.device)
    div = torch.empty(g, dtype=u.dtype, device=u.device) if with_divu else None
    cou = torch.zeros((), dtype=u.dtype, device=u.device) if courant_dt is not None else None
    dtw = wt(0.0 if courant_dt is None else courant_dt, u.dtype)
    dtdx = [dtw / wt(d_, u.dtype) for d_ in dx]
    _call("prim_aux", u, u.data_ptr(), q.data_ptr(), qaux.data_ptr(), _ptr(div),
          _ptr(cou), _ints(*g), _layout_args(L), eos_d, neutral, coef.data_ptr(),
          float(wt(small_dens, u.dtype)), float(wt(1e-200, u.dtype)), _dbls(*dx),
          _dbls(*dtdx), _stream(u))
    prim_aux.launches += 1
    ret = [q, qaux]
    if with_divu:
        ret.append(div)
    if courant_dt is not None:
        ret.append(cou)
    return tuple(ret)


prim_aux.launches = 0


# -- 2. flatten ----------------------------------------------------------------

def flatten_plain(q, layout):
    return uflatten(q, layout)


def flatten(q, layout):
    """Miller-Colella flattening coefficient flatn[grid] (all directions)."""
    if not _on_cuda(q):
        return flatten_plain(q, layout)
    L = layout
    check_kernel_layout(L)
    g = tuple(q.shape[1:])
    _check(q, "q", q.dtype, (L.NQ,) + g)
    out = torch.empty(g, dtype=q.dtype, device=q.device)
    consts = _dbls(wt(small_pressure(q.dtype), q.dtype), wt(SHKTST, q.dtype),
                   wt(ZCUT1, q.dtype), wt(DZCUT, q.dtype))
    _call("flatten", q, q.data_ptr(), out.data_ptr(), _ints(*g), L.QPRES, L.QU,
          consts, _stream(q))
    flatten.launches += 1
    return out


flatten.launches = 0


# -- 3. trace_ppm --------------------------------------------------------------

def trace_ppm_plain(q, qaux, srcQ, flatn, d, dt, dx_d, layout, small_dens,
                    small_pres, small_ener, fuse_riemann=None):
    qm, qp = trace_ppm_xla(q, qaux, srcQ, flatn, d, wt(dt, q.dtype), dx_d, layout,
                           small_dens, small_pres, small_ener)
    if fuse_riemann is None:
        return qm, qp
    flux, qe = cmpflx_qaux(qm, qp, qaux, d, layout, fuse_riemann["coord"],
                           fuse_riemann["riemann_solver"], small_dens, small_pres,
                           bnd_mask=fuse_riemann.get("bnd_mask"))
    return qm, qp, flux, qe


def trace_ppm(q, qaux, srcQ, flatn, d, dt, dx_d, layout, small_dens, small_pres,
              small_ener, fuse_riemann=None):
    """PPM trace of direction d: (qm, qp), or with `fuse_riemann = dict(
    coord=, riemann_solver=, bnd_mask=)` also the 1D flux and Godunov state:
    (qm, qp, flux, qe), as `pallas_kernels.trace_ppm_pallas`."""
    if not _on_cuda(q, qaux, flatn, srcQ):
        return trace_ppm_plain(q, qaux, srcQ, flatn, d, dt, dx_d, layout, small_dens,
                               small_pres, small_ener, fuse_riemann)
    L = layout
    check_kernel_layout(L)
    g = tuple(q.shape[1:])
    _check(q, "q", q.dtype, (L.NQ,) + g)
    _check(qaux, "qaux", q.dtype, (L.NQAUX,) + g)
    _check(flatn, "flatn", q.dtype, g)
    if srcQ is not None:
        _check(srcQ, "srcQ", q.dtype, (L.NQ,) + g)
    solver = 0
    mask = None
    if fuse_riemann is not None:
        solver = _kernel_solver(fuse_riemann["riemann_solver"])
        _check_cartesian(fuse_riemann["coord"])
        mask = fuse_riemann.get("bnd_mask")
    qm = torch.empty((L.NQ,) + g, dtype=q.dtype, device=q.device)
    qp = torch.empty_like(qm)
    flux = qe = None
    if fuse_riemann is not None:
        flux = torch.empty((L.NVAR,) + g, dtype=q.dtype, device=q.device)
        qe = torch.empty((L.NGDNV,) + g, dtype=q.dtype, device=q.device)
    dtw = wt(dt, q.dtype)
    consts = _dbls(dtw / wt(dx_d, q.dtype), wt(0.5, q.dtype) * dtw, wt(small_dens, q.dtype),
                   wt(small_pres, q.dtype), wt(small_dens * small_ener, q.dtype))
    mlo, mhi = _wall_index(mask)
    _call("trace_ppm", q, q.data_ptr(), qaux.data_ptr(), flatn.data_ptr(),
          _ptr(srcQ), qm.data_ptr(), qp.data_ptr(), _ptr(flux), _ptr(qe), _ints(*g),
          _layout_args(L), d, consts, solver, mlo, mhi, _stream(q))
    trace_ppm.launches += 1
    if fuse_riemann is None:
        return qm, qp
    return qm, qp, flux, qe


trace_ppm.launches = 0


def _kernel_solver(riemann_solver):
    if riemann_solver not in (0, 2):
        raise NotImplementedError(
            f"riemann_solver={riemann_solver} has no CUDA kernel: riemanncg runs as torch "
            "ops (ops/riemann.py)")
    return riemann_solver


def _check_cartesian(coord):
    """trace_ppm and ctu_face are 3D kernels, and a 3D grid is Cartesian."""
    if int(coord) != 0:
        raise ValueError(f"the 3D face kernels take Cartesian grids, not coord={int(coord)}")


def _coord(coord):
    if int(coord) not in (0, 1, 2):
        raise ValueError(f"coord={coord}: 0 Cartesian, 1 cylindrical, 2 spherical")
    return int(coord)


# -- 4. ctu_face ---------------------------------------------------------------

def _face_solve_plain(qm, qp, qaux, d, terms, layout, coord, riemann_solver,
                      small_dens, small_pres, reset_density, reset_rhoe, bnd_mask):
    if terms:
        dfp, drep, dpp = term_bundle(terms, qaux, d, 0, layout)
        dfm, drem, dpm = term_bundle(terms, qaux, d, -1, layout)
        qm = trans_apply_bundle(qm, dfm, drem, dpm, layout, small_pres,
                                reset_density, reset_rhoe)
        qp = trans_apply_bundle(qp, dfp, drep, dpp, layout, small_pres,
                                reset_density, reset_rhoe)
    return cmpflx_qaux(qm, qp, qaux, d, layout, coord, riemann_solver, small_dens,
                       small_pres, bnd_mask=bnd_mask)


def ctu_face_plain(qm, qp, qaux, d, terms, layout, coord, riemann_solver,
                   small_dens, small_pres, reset_density, reset_rhoe, bnd_mask=None,
                   terms2=None, consup=None):
    args = (layout, coord, riemann_solver, small_dens, small_pres, reset_density,
            reset_rhoe, bnd_mask)
    out = _face_solve_plain(qm, qp, qaux, d, terms, *args)
    if terms2 is not None:
        return out, _face_solve_plain(qm, qp, qaux, d, terms2, *args)
    if consup is not None:
        flux, qe = out
        hsrc, flc = consup_plain(
            consup["hsrc"], flux, qe[layout.GDPRES], qe[(layout.GDU, layout.GDV, layout.GDW)[d]],
            consup["div_node"], consup["u"], d, layout, consup["difmag"], consup["dx"],
            finalize_dt=consup.get("finalize_dt"))
        return (flc, qe), hsrc
    return out


def ctu_face(qm, qp, qaux, d, terms, layout, coord, riemann_solver, small_dens,
             small_pres, reset_density, reset_rhoe, bnd_mask=None, terms2=None,
             consup=None):
    """One CTU face stage, as `pallas_kernels.ctu_face_pallas`: terms=[]
    (plain Riemann), one corner term, two final terms; `terms2` pairs a
    second corner stage of the same normal and returns ((flux1, qe1),
    (flux2, qe2)); `consup = dict(hsrc=, div_node=, u=, difmag=, dx=,
    finalize_dt=)` (final stage) returns ((flux', qe), hsrc'). Each term is
    {'flux', 'qe', 't_dir', 'cdtdx'}."""
    if not _on_cuda(qm, qp, qaux):
        return ctu_face_plain(qm, qp, qaux, d, terms, layout, coord, riemann_solver,
                              small_dens, small_pres, reset_density, reset_rhoe,
                              bnd_mask, terms2, consup)
    L = layout
    check_kernel_layout(L)
    _check_cartesian(coord)
    solver = _kernel_solver(riemann_solver)
    dt_ = qm.dtype
    g = tuple(qm.shape[1:])
    _check(qm, "qm", dt_, (L.NQ,) + g)
    _check(qp, "qp", dt_, (L.NQ,) + g)
    _check(qaux, "qaux", dt_, (L.NQAUX,) + g)
    all_terms = list(terms) + list(terms2 or [])
    nt1, nt2 = len(terms), len(terms2 or [])
    variants = {(0, 0, False), (1, 0, False), (1, 1, False), (2, 0, False), (2, 0, True)}
    if (nt1, nt2, consup is not None) not in variants:
        raise ValueError(f"no ctu_face variant with {nt1}+{nt2} terms, consup={consup is not None}")
    # the kernel fixes the terms' directions with the normal's: the other two
    # axes in Castro order, or either of them for a lone corner term
    t1, t2 = [t for t in range(3) if t != d]
    dirs = tuple(int(t["t_dir"]) for t in all_terms)
    if dirs != (t1, t2)[:len(dirs)] and dirs != (t2,):
        raise ValueError(f"ctu_face with normal {d} takes terms along {t1} then {t2}, "
                         f"not {list(dirs)}")
    S = int(np.prod(g))
    isz = qm.element_size()
    F, pg, ug, cdt, tdir = [], [], [], [], []
    for t in all_terms:
        _check(t["flux"], "term flux", dt_, (L.NVAR,) + g)
        _check(t["qe"], "term qe", dt_, (L.NGDNV,) + g)
        base = t["qe"].data_ptr()
        F.append(t["flux"].data_ptr())
        pg.append(base + L.GDPRES * S * isz)
        ug.append(base + (L.GDU, L.GDV, L.GDW)[t["t_dir"]] * S * isz)
        cdt.append(float(wt(t["cdtdx"], dt_)))
        tdir.append(int(t["t_dir"]))
    while len(F) < 3:
        F.append(None), pg.append(None), ug.append(None), cdt.append(0.0), tdir.append(0)
    flux1 = torch.empty((L.NVAR,) + g, dtype=dt_, device=qm.device)
    qe1 = torch.empty((L.NGDNV,) + g, dtype=dt_, device=qm.device)
    flux2 = qe2 = hsrc = div = u = hout = None
    if nt2:
        flux2, qe2 = torch.empty_like(flux1), torch.empty_like(qe1)
    cons = [0.0, 0.0, 0.0, 0.0]
    with_fin = 0
    if consup is not None:
        hsrc, div, u = consup["hsrc"], consup["div_node"], consup["u"]
        _check(hsrc, "hsrc", dt_, (L.NVAR,) + g)
        _check(div, "div_node", dt_, g)
        _check(u, "u", dt_, (L.NVAR,) + g)
        hout = torch.empty_like(hsrc)
        dxd = float(consup["dx"][d])
        fin = consup.get("finalize_dt")
        with_fin = int(fin is not None)
        cons = [wt(consup["difmag"], dt_), wt(dxd, dt_), wt(1.0 / dxd, dt_),
                wt(0.0 if fin is None else fin, dt_)]
    vp3 = ctypes.c_void_p * 3
    mlo, mhi = _wall_index(bnd_mask)
    _call("ctu_face", qm, qm.data_ptr(), qp.data_ptr(), qaux.data_ptr(), _ints(*g),
          _layout_args(L), d, nt1, nt2, vp3(*F), vp3(*pg), vp3(*ug), _dbls(*cdt),
          _ints(*tdir), flux1.data_ptr(), qe1.data_ptr(), _ptr(flux2), _ptr(qe2),
          _ptr(hsrc), _ptr(div), _ptr(u), _ptr(hout), _dbls(*cons), with_fin, solver,
          mlo, mhi, int(bool(reset_density)), int(bool(reset_rhoe)),
          float(wt(small_dens, dt_)), float(wt(small_pres, dt_)), _stream(qm))
    ctu_face.launches += 1
    if nt2:
        return (flux1, qe1), (flux2, qe2)
    if consup is not None:
        return (flux1, qe1), hout
    return flux1, qe1


ctu_face.launches = 0


# -- 5. clean_fill ---------------------------------------------------------------

clean_fill_plain = clean_and_fill


def clean_fill(u, layout, eos, lo_bc, hi_bc, ng, small_dens, small_temp,
               dual_energy_eta2, do_normalize_species, with_status=False):
    """clean_state + ghost fill; with_status also returns the pre-clean
    interior min rho and the non-finite flag, as
    `pallas_kernels.clean_fill_pallas`."""
    if not _on_cuda(u):
        return clean_fill_plain(u, layout, eos, lo_bc, hi_bc, ng, small_dens, small_temp,
                                dual_energy_eta2, do_normalize_species, with_status)
    L = layout
    check_kernel_layout(L)
    g = tuple(u.shape[1:])
    _check(u, "u", u.dtype, (L.NVAR,) + g)
    for code in tuple(lo_bc) + tuple(hi_bc):
        if code not in (0, 1, 2) + WALLS:
            raise ValueError(f"unsupported BC code {code}")
    eos_d, neutral, coef = _eos_args(eos, L, u)
    out = torch.empty_like(u)
    mrho = total = None
    if with_status:
        mrho = torch.full((), float("inf"), dtype=u.dtype, device=u.device)
        total = torch.zeros((), dtype=u.dtype, device=u.device)
    dt_ = u.dtype
    consts = _dbls(wt(small_dens, dt_), wt(small_temp, dt_), wt(dual_energy_eta2, dt_),
                   wt(1e-300, dt_), wt(1e-30, dt_), wt(1.0 / L.nspec, dt_))
    _call("clean_fill", u, u.data_ptr(), out.data_ptr(), _ptr(mrho), _ptr(total),
          _ints(*g), _layout_args(L), _ints(*lo_bc), _ints(*hi_bc), ng, eos_d, neutral,
          coef.data_ptr(), consts, int(bool(do_normalize_species)), _stream(u))
    clean_fill.launches += 1
    if with_status:
        return out, mrho, ~torch.isfinite(total)
    return out


clean_fill.launches = 0


# -- 6. cmpflx -------------------------------------------------------------------

def cmpflx_plain(qm, qp, gamc_l, gamc_r, c_l, c_r, d, layout, coord, riemann_solver,
                 small_dens, small_pres, bnd_mask=None):
    ri = riemann_inputs(qm, qp, gamc_l, gamc_r, c_l, c_r, d, layout, small_dens)
    gd = solve(ri, _kernel_solver(riemann_solver), small_dens, small_pres)
    if bnd_mask is not None:
        bnd_mask = bnd_mask.tensor(qm.dtype, qm.device, qm.dim() - 1)
    return compute_flux(gd, qm, qp, d, layout, coord, bnd_mask=bnd_mask)


def cmpflx(qm, qp, gamc_l, gamc_r, c_l, c_r, d, layout, coord, riemann_solver,
           small_dens, small_pres, bnd_mask=None):
    """Pointwise Riemann solve (riemann_solver 0 or 2), flux [NVAR] and
    Godunov state [NGDNV] on every face of a 1D, 2D or 3D grid, given the
    face states and the gamc and c of the cells on both sides, as
    `pallas_kernels.cmpflx_pallas`; `bnd_mask` (a WallMask of direction d)
    zeroes the interface velocity on wall faces as `compute_flux` does, and
    `coord` 1 or 2 drops the pressure from the radial (d=0) momentum flux."""
    if not _on_cuda(qm, qp, gamc_l, gamc_r, c_l, c_r):
        return cmpflx_plain(qm, qp, gamc_l, gamc_r, c_l, c_r, d, layout, coord,
                            riemann_solver, small_dens, small_pres, bnd_mask)
    L = layout
    check_kernel_layout(L, dims=(1, 2, 3), radiation=True)
    coord = _coord(coord)
    solver = _kernel_solver(riemann_solver)
    dt_ = qm.dtype
    g = tuple(qm.shape[1:])
    _check(qm, "qm", dt_, (L.NQ,) + g)
    _check(qp, "qp", dt_, (L.NQ,) + g)
    for name, t in (("gamc_l", gamc_l), ("gamc_r", gamc_r), ("c_l", c_l), ("c_r", c_r)):
        _check(t, name, dt_, g)
    flux = torch.empty((L.NVAR,) + g, dtype=dt_, device=qm.device)
    qe = torch.empty((L.NGDNV,) + g, dtype=dt_, device=qm.device)
    mlo, mhi = _wall_index(bnd_mask)
    _call("cmpflx", qm, qm.data_ptr(), qp.data_ptr(), gamc_l.data_ptr(), gamc_r.data_ptr(),
          c_l.data_ptr(), c_r.data_ptr(), flux.data_ptr(), qe.data_ptr(), _grid3(g),
          _layout_args(L), d, coord, solver, mlo, mhi, float(wt(small_dens, dt_)),
          float(wt(small_pres, dt_)), _stream(qm))
    cmpflx.launches += 1
    return flux, qe


cmpflx.launches = 0


# -- 7. trans_apply ----------------------------------------------------------------

trans_apply_plain = trans_apply_bundle


def trans_apply(q_face, dflux, dreint_extra, dp, layout, small_pres, reset_density,
                reset_rhoe):
    """The transverse correction of one interface state given its summed
    bundle (`trans.term_bundle`): the conserved update, the density and
    (rho e) reset ladder, back to primitive; untouched components are
    copied through. As `pallas_kernels.trans_apply_pallas`, any dimension."""
    if not _on_cuda(q_face, dflux, dreint_extra, dp):
        return trans_apply_plain(q_face, dflux, dreint_extra, dp, layout, small_pres,
                                 reset_density, reset_rhoe)
    L = layout
    check_kernel_layout(L, dims=(1, 2, 3), radiation=True)
    dt_ = q_face.dtype
    g = tuple(q_face.shape[1:])
    _check(q_face, "q_face", dt_, (L.NQ,) + g)
    _check(dflux, "dflux", dt_, (L.NVAR,) + g)
    _check(dreint_extra, "dreint_extra", dt_, g)
    _check(dp, "dp", dt_, g)
    out = torch.empty_like(q_face)
    _call("trans_apply", q_face, q_face.data_ptr(), dflux.data_ptr(), dreint_extra.data_ptr(),
          dp.data_ptr(), out.data_ptr(), _grid3(g), _layout_args(L),
          int(bool(reset_density)), int(bool(reset_rhoe)), float(wt(small_pres, dt_)),
          _stream(q_face))
    trans_apply.launches += 1
    return out


trans_apply.launches = 0


# -- 8. trans_cmpflx ---------------------------------------------------------------

def trans_cmpflx_plain(qm, qp, df_m, df_p, dre_m, dre_p, dp_m, dp_p, gamc_l, gamc_r,
                       c_l, c_r, d, layout, coord, riemann_solver, small_dens, small_pres,
                       reset_density, reset_rhoe, bnd_mask=None):
    qm_c = trans_apply_bundle(qm, df_m, dre_m, dp_m, layout, small_pres, reset_density,
                              reset_rhoe)
    qp_c = trans_apply_bundle(qp, df_p, dre_p, dp_p, layout, small_pres, reset_density,
                              reset_rhoe)
    return cmpflx_plain(qm_c, qp_c, gamc_l, gamc_r, c_l, c_r, d, layout, coord,
                        riemann_solver, small_dens, small_pres, bnd_mask)


def trans_cmpflx(qm, qp, df_m, df_p, dre_m, dre_p, dp_m, dp_p, gamc_l, gamc_r, c_l, c_r,
                 d, layout, coord, riemann_solver, small_dens, small_pres,
                 reset_density, reset_rhoe, bnd_mask=None):
    """Transverse-correct both interface states with their summed bundles,
    then the Riemann solve and flux, in one pass: the corrected states are
    never written to memory. As `pallas_kernels.trans_cmpflx_pallas`;
    `coord` as in `cmpflx`."""
    tensors = (qm, qp, df_m, df_p, dre_m, dre_p, dp_m, dp_p, gamc_l, gamc_r, c_l, c_r)
    if not _on_cuda(*tensors):
        return trans_cmpflx_plain(*tensors, d, layout, coord, riemann_solver, small_dens,
                                  small_pres, reset_density, reset_rhoe, bnd_mask)
    L = layout
    check_kernel_layout(L, dims=(1, 2, 3), radiation=True)
    coord = _coord(coord)
    solver = _kernel_solver(riemann_solver)
    dt_ = qm.dtype
    g = tuple(qm.shape[1:])
    names = ("qm", "qp", "df_m", "df_p", "dre_m", "dre_p", "dp_m", "dp_p", "gamc_l",
             "gamc_r", "c_l", "c_r")
    lead = ((L.NQ,), (L.NQ,), (L.NVAR,), (L.NVAR,)) + ((),) * 8
    for name, t, nc in zip(names, tensors, lead):
        _check(t, name, dt_, nc + g)
    flux = torch.empty((L.NVAR,) + g, dtype=dt_, device=qm.device)
    qe = torch.empty((L.NGDNV,) + g, dtype=dt_, device=qm.device)
    mlo, mhi = _wall_index(bnd_mask)
    _call("trans_cmpflx", qm, *(t.data_ptr() for t in tensors), flux.data_ptr(),
          qe.data_ptr(), _grid3(g), _layout_args(L), d, coord, solver, mlo, mhi,
          int(bool(reset_density)), int(bool(reset_rhoe)), float(wt(small_dens, dt_)),
          float(wt(small_pres, dt_)), _stream(qm))
    trans_cmpflx.launches += 1
    return flux, qe


trans_cmpflx.launches = 0


# -- 9. consup -----------------------------------------------------------------------

def consup_plain(hsrc, flux, pg, ug, div_node, u, d, layout, difmag, dx, finalize_dt=None):
    """Direction d's consup: artificial viscosity, species normalization,
    the flux divergence and p div u added to hsrc, and u + dt*hsrc with
    `finalize_dt`. Returns (hsrc', flux'). The divergence multiplies by the
    rounded reciprocal of dx_d, as `consup_pallas` does."""
    L = layout
    flc = au.apply_av(flux, d, div_node, u, L, difmag, dx)
    flc = au.normalize_species_fluxes(flc, L)
    inv = 1.0 / float(dx[d])
    rows = -(shifted(flc, 1, 1 + d) - flc) * inv
    pdivu = 0.5 * (shifted(pg, 1, d) + pg) * (shifted(ug, 1, d) - ug) * inv
    rows[L.UEINT] = rows[L.UEINT] - pdivu
    htot = hsrc + rows
    if finalize_dt is not None:
        htot = u + wt(finalize_dt, u.dtype) * htot
    return htot, flc


def consup(hsrc, flux, pg, ug, div_node, u, d, layout, difmag, dx, finalize_dt=None):
    """One direction's conservative update of a 3D Cartesian grid, as
    `pallas_kernels.consup_pallas`: (hsrc + direction d's contribution, or
    u + finalize_dt * that; the flux with artificial viscosity and species
    normalization applied). `pg`, `ug` are the Godunov pressure and normal
    velocity on the faces of d. hsrc is returned new, not updated in place."""
    if not _on_cuda(hsrc, flux, pg, ug, div_node, u):
        return consup_plain(hsrc, flux, pg, ug, div_node, u, d, layout, difmag, dx,
                            finalize_dt)
    L = layout
    check_kernel_layout(L)
    dt_ = flux.dtype
    g = tuple(flux.shape[1:])
    for name, t in (("hsrc", hsrc), ("flux", flux), ("u", u)):
        _check(t, name, dt_, (L.NVAR,) + g)
    for name, t in (("pg", pg), ("ug", ug), ("div_node", div_node)):
        _check(t, name, dt_, g)
    hout = torch.empty_like(hsrc)
    fout = torch.empty_like(flux)
    dxd = float(dx[d])
    cons = _dbls(wt(difmag, dt_), wt(dxd, dt_), wt(1.0 / dxd, dt_),
                 wt(0.0 if finalize_dt is None else finalize_dt, dt_))
    _call("consup", flux, hsrc.data_ptr(), flux.data_ptr(), pg.data_ptr(), ug.data_ptr(),
          div_node.data_ptr(), u.data_ptr(), hout.data_ptr(), fout.data_ptr(), _ints(*g),
          _layout_args(L), d, cons, int(finalize_dt is not None), _stream(flux))
    consup.launches += 1
    return hout, fout


consup.launches = 0


KERNELS = (prim_aux, flatten, trace_ppm, ctu_face, clean_fill, cmpflx, trans_apply,
           trans_cmpflx, consup)


def _all_kernels():
    from castro_tpu_torch.ops import probes

    return KERNELS + probes.PROBES


def reset_launch_counts():
    for k in _all_kernels():
        k.launches = 0


def launch_counts() -> dict:
    """{kernel: launches since the last reset}, the three probes included."""
    return {k.__name__: k.launches for k in _all_kernels()}
