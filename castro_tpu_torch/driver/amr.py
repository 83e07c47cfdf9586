"""Block-structured AMR driver: a subcycled level hierarchy with fillpatch,
refluxing and averaging down.

Counterpart of `castro_tpu/driver/amr.py`, its hydro path (reference
semantics: AMReX `Amr::coarseTimeStep` recursion and Castro's subcycling,
`Castro_advance_ctu.cpp:504`; FillPatch space-time interpolation at
coarse-fine boundaries; `FluxRegister` refluxing,
`Source/driver/Castro.cpp:2549-2700`; `avgDown`; `errorEst` tagging; the
retry of `retry_advance_ctu` lifted to the hierarchy).

Each fine level is a dense window, the bucketed bounding box (multiples of
16 fine cells) of its tagged region plus a margin, at the level's
resolution, with a boolean refinement mask inside. Disjoint tag clusters
get windows of their own (`extra`). The unmasked ring of a window carries
time-interpolated coarse data, which is also the coarse-fine ghost region
of its stencil. Composite gravity (Cartesian PoissonGrav): level 0 solves
with the domain's multipole BCs, a window with Dirichlet phi on its faces
interpolated from its parent's phi at the substep's midpoint (the old and
new phi bracket the subcycle), the new coarse phi corrected once by the
delta-phi sync of the grad-phi flux register (`_solve_phi_sync`). Level 0
steps on the default context (the clean_fill kernel in 3D); a window
steps through a `StepCtx` with its position-correct geometry, whose step
ends in the torch-op clean + fill, as the JAX package routes it
(`castro_tpu/driver/sim.py:382`, `:578`). The clean + fill of `_avg_down`
and of a new window's state take the default route. Every
update of a level array is functional (a new tensor), so the pre-step
snapshot of `advance` and the old states of the time interpolation are
never written through.

Cartesian hydro with gravity and the sponge, and true SDC
(castro.time_integration_method=2): then level 0 and every window step
with `Simulation._sdc_step`, whose time-averaged face fluxes, in the exact
flux form of the SDC sweep, feed the flux registers
(`castro_tpu/driver/amr.py:149-173`, `:261-286`). As in the JAX driver, a
level's step is the CTU step otherwise, Strang-split only with
time_integration_method=0. Radiation, gray or multigroup (the JAX driver's
branches, `castro_tpu/driver/amr.py:221-234,383-413,573-602,702-762,
994-1049,1459-1575`): each level keeps its Er (`u_rad`, a leading group
axis when multigroup, `_rad_cax`) and steps with `Simulation.
_rad_step_impl`, a window's implicit solve Dirichlet on its faces with the
parent's Er at the substep's midpoint; the window's ring takes the
prolonged, time-interpolated coarse Er; the coarse-fine mismatch of the
radiation fluxes (advective + diffusive) feeds the parent's next implicit
solve as a deferred-sync rhs; covered coarse Er is the fine average. A
radiation hierarchy has one window a level (no extras), as in JAX. MHD (the
CTU-CT step, castro_tpu/driver/amr.py:350-384, 575-700, 744-788,
1050-1260, 1366-1555): each level keeps its face fields `u_b`; a window's
ring faces take the divergence-free prolongation (`prolong_face`) of the
time-interpolated coarse faces, its faces beside a masked cell stay the
window's own; the CT flux register corrects the coarse faces by the curl
of the accumulated fine-edge minus coarse-edge EMFs, which equals the
fine-face restriction on covered faces and the EMF reflux on the
interface, so div B stays 0 on every level; a regrid re-prolongs the
window's faces from the coarse level; one window a level, as in JAX. What
the JAX driver does beyond this raises, naming its ROADMAP.md item: a
device mesh or `amr.distribute_fine` (13, the sharded SDC, radiation and
MHD steps among them), plotfiles and checkpoints (14), and a curvilinear
grid (5, the Cartesian slice). Refinement ratio 2 on every level.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation, StepCtx, check_io_cadence
from castro_tpu_torch.driver.tagging import tag_cells
from castro_tpu_torch.geometry import CoordSys, geometry_from_params
from castro_tpu_torch.ops.interlevel import (coarsen_flux, prolong, prolong_face,
                                             prolong_mask, restrict, restrict_edge,
                                             restrict_face, restrict_mask)
from castro_tpu_torch.mhd.solver import EPS
from castro_tpu_torch.ops.stencil import interior_slice
from castro_tpu_torch.utils import constants as C

BUCKET = 16   # window extents rounded up to multiples of this (fine cells)
MARGIN = 8    # unmasked fine-cell ring kept around tags (>= ng + stencil)
MAX_WINDOWS = 8  # disjoint windows a level may have before the hull is taken


def _cluster_tags(t, merge_gap: int) -> List[tuple]:
    """Connected components of a boolean tag array (face neighbours;
    components whose bounding boxes come within `merge_gap` cells merge),
    as (lo, hi) index-bound pairs of numpy arrays, ordered as the JAX
    package orders them (`castro_tpu/driver/amr.py:_cluster_tags`): by each
    component's first cell in C order.

    `t` is a numpy array or a tensor, labelled where it lies, within the
    bounding box of its tags (C order within the box is C order within the
    array). Each tagged cell starts labelled by its own index; a pass takes
    the minimum of a cell's and its tagged neighbours' labels, then follows
    each label to the label of the cell it names (pointer jumping, which
    keeps every label inside its component), until nothing changes. Every
    component ends labelled by its first cell, in O(log diameter) passes
    where the JAX package's numpy propagation takes O(diameter)."""
    t = torch.as_tensor(t, dtype=torch.bool)
    if not bool(t.any()):
        return []
    dim = t.dim()
    nz = torch.nonzero(t)
    off = nz.min(0).values
    ext = nz.max(0).values - off + 1
    t = t[tuple(slice(int(o), int(o + e)) for o, e in zip(off.tolist(), ext.tolist()))]
    big = t.numel()
    idx = torch.arange(big, device=t.device).reshape(t.shape)
    lab = idx
    while True:
        nb = torch.where(t, lab, big)
        new = nb
        for d in range(dim):
            n = t.shape[d]
            if n == 1:
                continue
            pad = torch.full_like(nb.narrow(d, 0, 1), big)
            up = torch.cat([nb.narrow(d, 1, n - 1), pad], dim=d)    # neighbour at +1
            down = torch.cat([pad, nb.narrow(d, 0, n - 1)], dim=d)  # neighbour at -1
            new = torch.minimum(new, torch.minimum(up, down))
        new = torch.where(t, new, idx)
        flat = new.reshape(-1)
        new = flat[flat].reshape(t.shape)  # jump: a label names a cell of its component
        if torch.equal(new, lab):
            break
        lab = new
    roots, inv = torch.unique(lab[t], sorted=True, return_inverse=True)
    coords = torch.nonzero(t)  # C order, as lab[t]
    lo = torch.full((len(roots), dim), big, dtype=torch.int64, device=t.device)
    hi = torch.full((len(roots), dim), -1, dtype=torch.int64, device=t.device)
    index = inv[:, None].expand(-1, dim)
    lo = lo.scatter_reduce(0, index, coords, reduce="amin") + off
    hi = hi.scatter_reduce(0, index, coords, reduce="amax") + off
    boxes = list(zip(lo.cpu().numpy(), hi.cpu().numpy()))
    # merge boxes whose margin-padded extents overlap
    changed = True
    while changed:
        changed = False
        out = []
        for lo, hi in boxes:
            for k, (lo2, hi2) in enumerate(out):
                if np.all(lo <= hi2 + merge_gap) and np.all(lo2 <= hi + merge_gap):
                    out[k] = (np.minimum(lo, lo2), np.maximum(hi, hi2))
                    changed = True
                    break
            else:
                out.append((lo, hi))
        boxes = out
    return boxes


def _level_params(params: Params, level: int, n_cell: Optional[tuple] = None) -> Params:
    r = 2 ** level
    nc = n_cell if n_cell is not None else tuple(n * r for n in params.amr.n_cell)
    return params.with_ns("amr", n_cell=nc)


def _set(a, idx, value):
    """A copy of `a` with a[idx] = value (the JAX package's a.at[idx].set)."""
    out = a.clone()
    out[idx] = value
    return out


def _edge_pad(a, d):
    """`a` with its first and last plane along d repeated once (edge pad)."""
    return torch.cat([a.narrow(d, 0, 1), a, a.narrow(d, a.shape[d] - 1, 1)], dim=d)


def _lerp_axis(f, k, x):
    """Linear interpolation of f along axis k at the coordinates x (cell
    indices, numpy), as map_coordinates(order=1, mode="nearest") does it:
    the indices floor(x) and floor(x) + 1 clamped to [0, n-1], the weights
    1 - w and w, w = x - floor(x), in f's precision."""
    n = f.shape[k]
    xt = torch.as_tensor(x, dtype=f.dtype, device=f.device)
    lo = torch.floor(xt)
    w = xt - lo
    i0 = lo.to(torch.int64)
    shape = [1] * f.dim()
    shape[k] = len(x)
    w = w.reshape(shape)
    return (1.0 - w) * f.index_select(k, i0.clamp(0, n - 1)) + \
        w * f.index_select(k, (i0 + 1).clamp(0, n - 1))


def _pad_false(m, d, lo, hi):
    """Pad a boolean mask with `lo` and `hi` False planes along axis d."""
    parts = []
    for k in (lo, hi):
        shape = list(m.shape)
        shape[d] = k
        parts.append(torch.zeros(shape, dtype=torch.bool, device=m.device))
    return torch.cat([parts[0], m, parts[1]], dim=d)


class _GeomShim:
    """A sim seen through a position-correct window geometry, for the
    problem_init and problem_tagging hooks on fine windows."""

    def __init__(self, sim, geom):
        self._sim = sim
        self.geom = geom

    def __getattr__(self, name):
        return getattr(self._sim, name)


class _Level:
    """One fine level's Simulation for one window shape, and its step; the
    window's origin arrives with each step."""

    def __init__(self, params, level, shape_f, geom_full, **sim_kw):
        self.shape = tuple(shape_f)
        dim = geom_full.dim
        # dx-correct window geometry (origin 0 here; the true origin comes
        # with each step)
        geom_win = geom_full.local_view(self.shape, (0,) * dim)
        self.sim = Simulation(_level_params(params, level, self.shape), geom=geom_win,
                              **sim_kw)
        self.sim.keep_fluxes = True
        self.geom_full = geom_full
        self.grav = _poisson_gravity(self.sim)

    def _ctx(self, ilo, grav_bc):
        sim = self.sim
        geom = self.geom_full.local_view(self.shape, tuple(int(v) for v in ilo))
        return StepCtx(fill=sim._fill, pmin=torch.min, pany=lambda b: b, geom=geom,
                       grav_bc=grav_bc)

    def step(self, u, dt, t, ilo, grav_bc=None):
        if self.sim.sdc is not None:
            # the window's true-SDC step: its MOL evaluations read only dx
            # from the window's geometry, and the ring carries the
            # coarse-fine data as for CTU (castro_tpu/driver/amr.py:149-173)
            return _sdc_level_step(self.sim, u, dt, t, True)
        return self.sim._step_impl(u, dt, t, ctx=self._ctx(ilo, grav_bc))

    def rad_step(self, u, Er, dt, t, ilo, grav_bc=None, rad_bc=None, rad_rhs_extra=None):
        """The window's radiation step, with its register fluxes."""
        return self.sim._rad_step_impl(u, Er, dt, t, ctx=self._ctx(ilo, grav_bc), rad_bc=rad_bc,
                                       rad_rhs_extra=rad_rhs_extra, keep_rad_flux=True)

    def mhd_step(self, u, b, dt, t, ilo, grav_bc=None):
        """The window's MHD step with its CT register data."""
        return self.sim._mhd_step_impl(u, b, dt, t, ctx=self._ctx(ilo, grav_bc), keep_ct=True)

    def phi(self, rho, ilo, grav_bc):
        """The window's phi from its interior density, Dirichlet on its faces
        with `grav_bc` (PoissonGrav only)."""
        return self.grav._poisson(rho, self._ctx(ilo, grav_bc))[1]


def _sdc_level_step(sim, u, dt, t, keep_fluxes):
    """A level's true-SDC step in the CTU step's form, (u_new, min_rho,
    bad[, interior face fluxes]), the burn's failure folded into bad."""
    out = sim._sdc_step(u, dt, t, keep_fluxes=keep_fluxes)
    return (out[0], out[1], out[2] | out[3]) + tuple(out[4:])


def _poisson_gravity(sim):
    """The Gravity of a sim's PoissonGrav source, else None."""
    g = next((fn.gravity for fn in sim.source_fns if getattr(fn, "name", "") == "grav"), None)
    return g if g is not None and g.gtype == "PoissonGrav" else None


def _unported_amr(params, sim0, mesh):
    """The ROADMAP.md item of the first AMR feature of the JAX driver that
    this configuration needs and the port does not have yet."""
    checks = [
        (mesh is not None or bool(params.amr.distribute_fine),
         "a device mesh or amr.distribute_fine (queue 1 item 13)"),
        (sim0.geom.coord != CoordSys.CARTESIAN,
         "AMR on a curvilinear grid (queue 1 item 5, its Cartesian slice)"),
        (bool(params.castro.hybrid_hydro) and sim0.layout.hybrid_momentum,
         "hybrid_hydro on AMR, its source at a window's position (queue 1 item 5)"),
    ]
    return next((item for bad, item in checks if bad), None)


class AmrSimulation:
    """The level hierarchy: level 0 is a whole-domain Simulation, finer
    levels are dense windows with a Simulation per window shape."""

    def __init__(self, params: Params, problem_init: Optional[Callable] = None,
                 problem_tagging: Optional[Callable] = None, mesh=None, device=None,
                 **sim_kw):
        """device: None = "cuda"; the tests pass "cpu". `problem_tagging(sim,
        u_int, level)` adds tags. `mesh` (distributed AMR) raises: not
        ported yet."""
        self.params = params
        self.max_level = params.amr.max_level
        self.ref_ratio = 2
        self.problem_init = problem_init
        self.problem_tagging = problem_tagging
        self.indicators = self._parse_indicators(params)
        self._sim_kw = dict(sim_kw, device=device)

        self.sim0 = Simulation(_level_params(params, 0), problem_init=problem_init,
                               **self._sim_kw)
        item = _unported_amr(params, self.sim0, mesh)
        if item is not None:
            raise NotImplementedError(f"not ported yet: {item}, see ROADMAP.md")
        self.sim0.keep_fluxes = self.max_level > 0
        self.device = self.sim0.device
        self.dim = self.sim0.layout.dim
        self.ng = self.sim0.ng
        self.dtype = self.sim0.dtype

        # full-domain geometry per level (window views hang off these)
        self.geom_full = [geometry_from_params(_level_params(params, l), self.dtype,
                                               self.device)
                          for l in range(self.max_level + 1)]

        # per-level window (ilo_f ndarray[dim], shape_f tuple) in level-l
        # cells; level 0 is the whole domain
        n0 = tuple(params.amr.n_cell[: self.dim])
        self.window: List = [(np.zeros(self.dim, int), n0)] + [None] * self.max_level
        self._levels: List[Dict] = [dict() for _ in range(self.max_level + 1)]

        self.u: List = [None] * (self.max_level + 1)
        self.u_old: List = [None] * (self.max_level + 1)
        self.masks: List = [None] * (self.max_level + 1)
        self.t = 0.0
        self.step_count = 0
        self.dt = None
        self.num_zones_advanced = 0
        # windows of disjoint tag clusters beyond the primary, per level:
        # {ilo, shape, u, mask, grav_bc}
        self.extra: List[List[dict]] = [[] for _ in range(self.max_level + 1)]
        # composite gravity (Cartesian PoissonGrav, castro_tpu/driver/amr.py:
        # 326-337): each window level's grav_bc for the current substep, set
        # by its parent's subcycle loop
        self._grav0 = _poisson_gravity(self.sim0)
        self._has_poisson = self._grav0 is not None
        self._cur_grav_bc: Dict[int, object] = {}
        self.phi_sync_resid = None
        # radiation: per-level Er (a leading group axis when multigroup),
        # the window Dirichlet data of the current substep, and each level's
        # deferred-sync rhs for its next implicit solve
        self._has_rad = self.sim0.rad is not None
        self._rad_cax = 1 if self.sim0.layout.ngroups > 1 else 0
        self.u_rad: List = [None] * (self.max_level + 1)
        self.u_rad_old: List = [None] * (self.max_level + 1)
        self._cur_rad_bc: Dict[int, object] = {}
        self._rad_sync_rhs: Dict[int, object] = {}
        # MHD: per-level face fields, and their old values for the time
        # interpolation of the ring faces (castro_tpu/driver/amr.py:349-385)
        self._has_mhd = bool(params.castro.do_mhd) and self.max_level > 0
        if self._has_mhd and not params.castro.mhd_ctu:
            raise ValueError("AMR MHD takes the CTU-CT step (castro.mhd_ctu=1): its CT "
                             "register data come from it")
        if self._has_mhd and self._has_rad:
            raise ValueError("AMR MHD with radiation is not composed (the reference has no "
                             "rad-MHD)")
        self.u_b: List = [None] * (self.max_level + 1)
        self.u_b_old: List = [None] * (self.max_level + 1)

    # ------------------------------------------------------------------ setup
    @staticmethod
    def _parse_indicators(params) -> List[Dict]:
        """`amr.refinement_indicators` names with their `amr.<name>.*` keys
        from params.extra (reference runtime tagging syntax,
        Castro.cpp:560-615)."""
        inds = []
        for name in params.amr.refinement_indicators:
            spec = {}
            base = f"amr.{name}."
            for k, v in params.extra.items():
                if k.startswith(base):
                    spec[k[len(base):]] = v
            ind = {"field": spec.get("field", "density"), "max_level": spec.get("max_level")}
            for test in ("value_greater", "value_less", "gradient", "relative_gradient"):
                if test in spec:
                    ind["test"] = test
                    ind["value"] = spec[test]
            if "test" in ind:
                inds.append(ind)
        return inds

    def _get_level(self, l, shape_f) -> _Level:
        """The level-l Simulation of a window shape, cached by shape."""
        key = tuple(shape_f)
        cache = self._levels[l]
        if key not in cache:
            cache[key] = _Level(self.params, l, key, self.geom_full[l], **self._sim_kw)
        return cache[key]

    def _sims_at(self, l) -> Simulation:
        if l == 0:
            return self.sim0
        return self._get_level(l, self.window[l][1]).sim

    @property
    def sims(self):
        """Per-level Simulation list (the window sims for fine levels)."""
        return [self._sims_at(l) for l in range(self.max_level + 1)]

    # ------------------------------------------------------------------ window
    def _nest_bounds(self, l_fine):
        """The fine-cell bounds [blo, bhi) a level-l_fine window must lie in:
        the parent's primary window's footprint for l_fine >= 2 (proper
        nesting), else the whole level."""
        if l_fine - 1 > 0 and self.window[l_fine - 1] is not None:
            p_ilo, p_shape = self.window[l_fine - 1]
            return (tuple(2 * int(p_ilo[k]) for k in range(self.dim)),
                    tuple(2 * (int(p_ilo[k]) + p_shape[k]) for k in range(self.dim)))
        return ((0,) * self.dim,
                tuple(self.params.amr.n_cell[k] * 2 ** l_fine for k in range(self.dim)))

    def _compute_window(self, l_fine, tags_global_c):
        """Bucketed bounding box (+ margin) of the tagged level-(l_fine - 1)
        cells, as a level-l_fine window (ilo_f, shape_f). tags_global_c is
        a numpy bool array over the coarse level's full grid."""
        blo, bhi = self._nest_bounds(l_fine)
        t = np.asarray(tags_global_c)
        if not t.any():
            # minimal window (keeps shapes static when nothing is tagged)
            shape = tuple(min(BUCKET, bhi[k] - blo[k]) for k in range(self.dim))
            return np.asarray(blo, int), shape
        box_lo, box_hi = [], []
        for k in range(self.dim):
            axes = tuple(a for a in range(self.dim) if a != k)
            proj = t.any(axis=axes) if self.dim > 1 else t
            idx = np.nonzero(proj)[0]
            box_lo.append(idx[0])
            box_hi.append(idx[-1])
        return self._box_to_window(np.asarray(box_lo), np.asarray(box_hi), blo, bhi)

    def _box_to_window(self, box_lo, box_hi, blo, bhi):
        """Coarse-cell tag bbox -> bucketed fine window (ilo, shape),
        clamped to the [blo, bhi) fine-cell bounds."""
        ilo, shape = [], []
        for k in range(self.dim):
            lo_f = max(blo[k], 2 * int(box_lo[k]) - MARGIN)
            hi_f = min(bhi[k], 2 * (int(box_hi[k]) + 1) + MARGIN)
            ext = int(np.ceil((hi_f - lo_f) / BUCKET)) * BUCKET
            ext = min(ext, bhi[k] - blo[k])
            lo_f = max(blo[k], min(lo_f - (ext - (hi_f - lo_f)) // 2, bhi[k] - ext))
            lo_f -= lo_f % 2  # even alignment for restriction
            lo_f = max(blo[k], lo_f)
            ilo.append(int(lo_f))
            shape.append(int(ext))
        return np.asarray(ilo, int), tuple(shape)

    def _compute_extra_windows(self, l_fine, tags_global_c):
        """The primary window and the windows of disjoint tag clusters
        beyond it, proper-nested inside the parent's primary window (extras
        spawn no children). Returns (primary, extras), the primary the
        largest; if any two overlap after bucketing, the hull alone.
        tags_global_c: a bool tensor over the coarse level's full grid."""
        t = tags_global_c.cpu().numpy()
        if not t.any():
            return self._compute_window(l_fine, t), []
        boxes = _cluster_tags(tags_global_c, merge_gap=MARGIN)
        if len(boxes) <= 1 or len(boxes) > MAX_WINDOWS:
            return self._compute_window(l_fine, t), []
        blo, bhi = self._nest_bounds(l_fine)
        wins = [self._box_to_window(lo, hi, blo, bhi) for lo, hi in boxes]
        wins.sort(key=lambda w: -int(np.prod(w[1])))
        for a in range(len(wins)):
            for b in range(a + 1, len(wins)):
                la, sa = wins[a]
                lb, sb = wins[b]
                if np.all(la < lb + np.asarray(sb)) and np.all(lb < la + np.asarray(sa)):
                    return self._compute_window(l_fine, t), []
        return wins[0], wins[1:]

    def _win_geom(self, l, win=None):
        ilo, shape = win if win is not None else self.window[l]
        return self.geom_full[l].local_view(shape, tuple(int(v) for v in ilo))

    def _coarse_slice(self, l, grow=0, win=None):
        """Slice of the level-(l-1) full interior covered by level l's
        window (coarse cells), optionally grown (clamped)."""
        ilo, shape = win if win is not None else self.window[l]
        sl = []
        for k in range(self.dim):
            lo = int(ilo[k]) // 2 - grow
            hi = (int(ilo[k]) + shape[k]) // 2 + grow
            sl.append(slice(max(0, lo), hi))
        return tuple(sl)

    # ------------------------------------------------------------------ init
    def init_data(self):
        """Initial hierarchy (reference Amr::init loop: init level 0, tag,
        create level 1 from problem data, repeat)."""
        self.sim0.init_data()
        self.u[0] = self.sim0.u
        self.masks[0] = torch.ones(self.sim0.geom.n_cell, dtype=torch.bool,
                                   device=self.device)
        if self._has_rad:
            self.u_rad[0] = self.sim0.u_rad
        if self._has_mhd:
            self.u_b[0] = self.sim0.u_b
        for l in range(1, self.max_level + 1):
            tags = self._tags_for(l - 1)
            (ilo, shape), extras = self._windows_for(l, tags)
            self.window[l] = (ilo, shape)
            if self._has_mhd:
                self.u[l], self.u_b[l] = self._make_window_state_mhd(l, (ilo, shape))
            else:
                self.u[l] = self._make_window_state(l, (ilo, shape))
            self.masks[l] = self._window_mask(l, tags)
            self.extra[l] = [{"ilo": e[0], "shape": e[1], "u": self._make_window_state(l, e),
                              "mask": self._window_mask(l, tags, win=e), "grav_bc": None}
                             for e in extras]
            if self._has_rad:
                self.u_rad[l] = self._prolong_rad(l, (ilo, shape))
        return self

    def _windows_for(self, l, tags):
        """The level-l primary window and its extras; a radiation or MHD
        hierarchy takes the one bounding window (castro_tpu/driver/amr.py:
        579-583)."""
        if self._has_rad or self._has_mhd:
            return self._compute_window(l, tags.cpu().numpy()), []
        return self._compute_extra_windows(l, tags)

    def _prolong_rad(self, l, win=None, frac=None):
        """The parent's Er (time-interpolated at `frac` between its old and
        new Er when given) over a level-l window, prolonged."""
        Er_c = self.u_rad[l - 1] if frac is None else \
            (1.0 - frac) * self.u_rad_old[l - 1] + frac * self.u_rad[l - 1]
        cx = (slice(None),) * self._rad_cax
        return prolong(Er_c[cx + self._parent_rel_slice(l, win=win)], self.dim,
                       comp_axes=self._rad_cax)

    def _make_window_state(self, l, win):
        """Problem data on one window (position-correct shim) + clean."""
        ilo, shape = win
        lev = self._get_level(l, shape)
        u = torch.zeros((self.sim0.layout.NVAR,) + tuple(s + 2 * self.ng for s in shape),
                        dtype=self.dtype, device=self.device)
        if self.problem_init is not None:
            u = self.problem_init(_GeomShim(lev.sim, self._win_geom(l, win=win)), u)
        return lev.sim._clean_fill_impl(u.to(self.dtype))

    def _make_window_state_mhd(self, l, win):
        """Problem data (u, b) on one window (reference Amr::init calls
        initData a level: the MHD hooks define the face field analytically,
        so the window's B is divergence-free by construction, as at level
        0), the magnetic energy folded in, the faces filled, the MHD clean."""
        ilo, shape = win
        mhd = self._get_level(l, shape).sim.mhd
        gshape = tuple(s + 2 * self.ng for s in shape)
        u = torch.zeros((self.sim0.layout.NVAR,) + gshape, dtype=self.dtype, device=self.device)
        b = tuple(torch.zeros(gshape, dtype=self.dtype, device=self.device) for _ in range(3))
        if self.problem_init is not None:
            u, b = self.problem_init(_GeomShim(mhd.sim, self._win_geom(l, win=win)), u, b)
        b = tuple(torch.as_tensor(bb, dtype=self.dtype, device=self.device).expand(gshape)
                  for bb in b)
        u = mhd.add_magnetic_energy(u.to(self.dtype), b)
        b = mhd.fill_b_all(b)
        return mhd._clean(u, b), b

    def _tags_for(self, l):
        """Dense tags over level l's full grid (window tags scattered)."""
        sim = self._sims_at(l)
        u_int = self.u[l][interior_slice(self.ng, self.dim)]
        shim = _GeomShim(sim, self._win_geom(l) if l > 0 else sim.geom)
        tags_win = tag_cells(shim, u_int, self.indicators, l, self.params.amr.n_error_buf,
                             self.problem_tagging)
        tags_win = tags_win & self.masks[l]  # proper nesting
        if l == 0:
            return tags_win
        full = torch.zeros(self.geom_full[l].n_cell, dtype=torch.bool, device=self.device)
        ilo, shape = self.window[l]
        full[tuple(slice(int(ilo[k]), int(ilo[k]) + shape[k]) for k in range(self.dim))] = \
            tags_win
        return full

    def _window_mask(self, l, tags_global_c, win=None):
        """Level-l window mask from the coarse level's tags."""
        return prolong_mask(tags_global_c[self._coarse_slice(l, win=win)], self.dim)

    # ------------------------------------------------------------------ regrid
    def _migrate_window(self, l, win, old_wins, fill_new=True, b_clean=None):
        """A (new) level-l window's state: prolonged coarse data everywhere,
        then the old windows' valid (masked) fine data where they overlap.
        Returns the grown, cleaned state; with `b_clean`, the window's
        migrated face field, the MHD clean (its energy reset takes the
        magnetic energy out)."""
        new_ilo, new_shape = win
        lev = self._get_level(l, new_shape)
        c_int = self.u[l - 1][interior_slice(self.ng, self.dim)]
        csl = self._parent_rel_slice(l, win=win)
        new_int = prolong(c_int[(slice(None),) + csl], self.dim)
        if fill_new:
            for old_ilo, old_shape, old_u, old_mask in old_wins:
                old_int = old_u[interior_slice(self.ng, self.dim)]
                lo = np.maximum(np.asarray(new_ilo), np.asarray(old_ilo))
                hi = np.minimum(np.asarray(new_ilo) + np.asarray(new_shape),
                                np.asarray(old_ilo) + np.asarray(old_shape))
                if np.all(hi > lo):
                    src = (slice(None),) + tuple(
                        slice(int(lo[k] - old_ilo[k]), int(hi[k] - old_ilo[k]))
                        for k in range(self.dim))
                    dst = (slice(None),) + tuple(
                        slice(int(lo[k] - new_ilo[k]), int(hi[k] - new_ilo[k]))
                        for k in range(self.dim))
                    m_src = old_mask[src[1:]]
                    new_int = _set(new_int, dst,
                                   torch.where(m_src[None], old_int[src], new_int[dst]))
        pads = []
        for _ in range(self.dim):
            pads += [self.ng, self.ng]
        new_u = torch.nn.functional.pad(new_int, pads)
        if b_clean is not None:
            return lev.sim.mhd._clean(new_u, b_clean)
        return lev.sim._clean_fill_impl(new_u)

    def regrid(self, fill_new=True):
        """Re-tag every level; move or resize the windows (the extras too),
        migrating their data (reference Amr regrid + FillCoarsePatch for
        new regions)."""
        for l in range(self.max_level):
            tags = self._tags_for(l)
            (new_ilo, new_shape), new_extras = self._windows_for(l + 1, tags)
            new_rad = None
            if self._has_rad:
                # prolonged coarse Er, the old window's masked fine Er kept
                # where the windows overlap (castro_tpu/driver/amr.py:717-739)
                new_rad = self._prolong_rad(l + 1, win=(new_ilo, new_shape))
                if self.u_rad[l + 1] is not None and fill_new:
                    old_ilo, old_shape = self.window[l + 1]
                    lo = np.maximum(new_ilo, old_ilo)
                    hi = np.minimum(new_ilo + np.asarray(new_shape),
                                    old_ilo + np.asarray(old_shape))
                    if np.all(hi > lo):
                        cx = (slice(None),) * self._rad_cax
                        src = cx + tuple(slice(int(lo[k] - old_ilo[k]), int(hi[k] - old_ilo[k]))
                                         for k in range(self.dim))
                        dst = cx + tuple(slice(int(lo[k] - new_ilo[k]), int(hi[k] - new_ilo[k]))
                                         for k in range(self.dim))
                        m_src = self.masks[l + 1][src[self._rad_cax:]]
                        new_rad = _set(new_rad, dst, torch.where(m_src, self.u_rad[l + 1][src],
                                                                 new_rad[dst]))
            old_wins = []
            if self.u[l + 1] is not None:
                old_wins.append((self.window[l + 1][0], self.window[l + 1][1],
                                 self.u[l + 1], self.masks[l + 1]))
                old_wins += [(e["ilo"], e["shape"], e["u"], e["mask"])
                             for e in self.extra[l + 1]]
            # the primary first (its _parent_rel_slice reads window[l + 1]
            # only through the explicit win argument). MHD: the face field
            # is the divergence-free prolongation of the coarse faces
            # everywhere (the covered coarse faces carry the fine data
            # through the CT register, so re-prolonging keeps div B = 0
            # exactly through a window's move; old fine faces copied into a
            # moved window would seed divergence at the seam)
            new_b = self._prolong_window_b(l + 1, win=(new_ilo, new_shape)) \
                if self._has_mhd else None
            u_new = self._migrate_window(l + 1, (new_ilo, new_shape), old_wins, fill_new,
                                         b_clean=new_b)
            new_extra_state = [
                {"ilo": e[0], "shape": e[1],
                 "u": self._migrate_window(l + 1, e, old_wins, fill_new),
                 "mask": self._window_mask(l + 1, tags, win=e), "grav_bc": None}
                for e in new_extras]
            self.window[l + 1] = (new_ilo, new_shape)
            self.u[l + 1] = u_new
            self.masks[l + 1] = self._window_mask(l + 1, tags)
            self.extra[l + 1] = new_extra_state
            if new_rad is not None:
                self.u_rad[l + 1] = new_rad
            if new_b is not None:
                self.u_b[l + 1] = new_b

    # ------------------------------------------------------------------ dt
    def estimate_dt(self) -> float:
        """Level-0 dt respecting all levels (reference computeNewDt with
        subcycling: dt_0 = min_l dt_l * prod(ref_ratio))."""
        c = self.params.castro

        def level_dt(sim, l):
            if self._has_mhd:
                return float(sim._mhd_estdt_impl(self.u[l], self.u_b[l]))
            return float(sim._estdt_impl(self.u[l], self.u_rad[l]))

        dt = level_dt(self.sim0, 0)
        for l in range(1, self.max_level + 1):
            lev = self._get_level(l, self.window[l][1])
            dt = min(dt, level_dt(lev.sim, l) * self.ref_ratio ** l)
            for e in self.extra[l]:
                lev_e = self._get_level(l, e["shape"])
                dt = min(dt, float(lev_e.sim._estdt_impl(e["u"])) * self.ref_ratio ** l)
        if self.step_count == 0:
            dt *= c.init_shrink
        elif self.dt is not None:
            dt = min(dt, c.change_max * self.dt)
        return min(dt, c.max_dt)

    # ------------------------------------------------------------------ advance
    def _ring_fill(self, l, frac, win, u_w, mask_w):
        """One window's unmasked cells := prolonged coarse data, time-
        interpolated between the coarse old and new states (FillPatch)."""
        c_interp = (1.0 - frac) * self.u_old[l - 1] + frac * self.u[l - 1]
        c_int = c_interp[interior_slice(self.ng, self.dim)]
        csl = self._parent_rel_slice(l, win=win)
        fine = prolong(c_int[(slice(None),) + csl], self.dim)
        idx = interior_slice(self.ng, self.dim)
        return _set(u_w, idx, torch.where(mask_w[None], u_w[idx], fine))

    def _set_unmasked_from_coarse(self, l, frac):
        self.u[l] = self._ring_fill(l, frac, self.window[l], self.u[l], self.masks[l])

    def _parent_rel_slice(self, l, win=None):
        """Level-l window's footprint inside the parent's stored interior
        (parent window coordinates for l-1 > 0, global for l-1 == 0)."""
        ilo, shape = win if win is not None else self.window[l]
        if l - 1 == 0:
            base = np.zeros(self.dim, int)
        else:
            base = 2 * np.asarray(self.window[l - 1][0], int)
        return tuple(slice((int(ilo[k]) - int(base[k])) // 2,
                           (int(ilo[k]) - int(base[k]) + shape[k]) // 2)
                     for k in range(self.dim))

    @staticmethod
    def _check(out, what, at=1):
        """Raise RuntimeError if a level step failed: one host sync for the
        min density (out[at]) and the flag (out[at + 1]) together."""
        mr, bad = torch.stack([out[at].to(torch.float64),
                               out[at + 1].to(torch.float64)]).tolist()
        if bad or mr <= 0.0:
            raise RuntimeError(f"AMR advance failed {what} (min_rho={mr})")

    def _keep_masked(self, u_old_w, u_new_w, mask):
        """The window's state with the step's result in its masked cells."""
        idx = interior_slice(self.ng, self.dim)
        return _set(u_old_w, idx, torch.where(mask[None], u_new_w[idx], u_old_w[idx]))

    def _advance_level(self, l, dt, t_level):
        """Advance level l by dt; recursively subcycle the finer levels
        (reference Amr::timeStep recursion). Returns level l's interior
        face fluxes (None without a finer level at level 0) and, with
        radiation, its radiation register fluxes (else None)."""
        self.u_old[l] = self.u[l]
        if self._has_rad:
            return self._advance_level_rad(l, dt, t_level)
        if self._has_mhd:
            return self._advance_level_mhd(l, dt, t_level)
        if l == 0:
            sim = self.sim0
            if sim.sdc is not None:  # castro_tpu/driver/amr.py:261-286
                out = _sdc_level_step(sim, self.u[0], dt, t_level, sim.keep_fluxes)
            else:
                out = sim._step_impl(self.u[0], dt, t_level)
        else:
            lev = self._get_level(l, self.window[l][1])
            sim = lev.sim
            out = lev.step(self.u[l], dt, t_level, self.window[l][0],
                           grav_bc=self._cur_grav_bc.get(l))
        fluxes = out[3] if sim.keep_fluxes else None
        self._check(out, f"at level {l}, t={t_level}")
        if l == 0:
            self.u[0] = out[0]
        else:
            self.u[l] = self._keep_masked(self.u[l], out[0], self.masks[l])
        del out
        self._advance_finer(l, dt, t_level, fluxes)
        return fluxes, None

    def _advance_level_rad(self, l, dt, t_level):
        """Level l's radiation step (castro_tpu/driver/amr.py:1307-1364):
        the deferred-sync rhs of the last coarse step into its implicit
        solve, a window's coarse-Er Dirichlet faces; then the finer levels."""
        self.u_rad_old[l] = self.u_rad[l]
        rhs_extra = self._rad_sync_rhs.pop(l, None)
        if l == 0:
            out = self.sim0._rad_step_impl(self.u[0], self.u_rad[0], dt, t_level,
                                           rad_rhs_extra=rhs_extra, keep_rad_flux=True)
        else:
            lev = self._get_level(l, self.window[l][1])
            out = lev.rad_step(self.u[l], self.u_rad[l], dt, t_level, self.window[l][0],
                               grav_bc=self._cur_grav_bc.get(l),
                               rad_bc=self._cur_rad_bc.get(l), rad_rhs_extra=rhs_extra)
        u_new, Er_new, _, _, rad_fluxes, fluxes = out
        self._check(out, f"(radiation) at level {l}, t={t_level}", at=2)
        if l == 0:
            self.u[0] = u_new
            self.u_rad[0] = Er_new
        else:
            self.u[l] = self._keep_masked(self.u[l], u_new, self.masks[l])
            self.u_rad[l] = torch.where(self.masks[l], Er_new, self.u_rad[l])
        del out, u_new
        self._advance_finer(l, dt, t_level, fluxes, rad_fluxes)
        return fluxes, rad_fluxes

    def _advance_level_mhd(self, l, dt, t_level):
        """Level l's MHD step (castro_tpu/driver/amr.py:1366-1393) with its
        CT register data; the window keeps its whole face field (the ring
        faces are refilled from the coarse level before every substep);
        then the finer levels. Returns (interior gas fluxes, CT data)."""
        self.u_b_old[l] = self.u_b[l]
        if l == 0:
            out = self.sim0._mhd_step_impl(self.u[0], self.u_b[0], dt, t_level, keep_ct=True)
        else:
            lev = self._get_level(l, self.window[l][1])
            out = lev.mhd_step(self.u[l], self.u_b[l], dt, t_level, self.window[l][0],
                               grav_bc=self._cur_grav_bc.get(l))
        u_new, b_new, _, _, fluxes, ct = out
        self._check(out, f"(MHD) at level {l}, t={t_level}", at=2)
        if l == 0:
            self.u[0] = u_new
        else:
            self.u[l] = self._keep_masked(self.u[l], u_new, self.masks[l])
        self.u_b[l] = b_new
        del out, u_new
        self._advance_finer(l, dt, t_level, fluxes, ct)
        return fluxes, ct

    def _rad_face_pad(self, F, d):
        """A cell-registered radiation flux with its hi face appended (zero)."""
        shape = list(F.shape)
        shape[self._rad_cax + d] = 1
        return torch.cat([F, torch.zeros(shape, dtype=F.dtype, device=F.device)],
                         dim=self._rad_cax + d)

    def _advance_finer(self, l, dt, t_level, fluxes, aux=None):
        """Subcycle level l+1 (if any), then reflux and average down (with
        radiation also its deferred sync and Er average; with MHD first the
        CT register's correction of the coarse faces). `aux`: level l's
        radiation register fluxes, or its CT data."""
        if l >= self.max_level:
            return
        rad_fluxes = aux if self._has_rad else None
        mhd_E_acc: Dict = {}
        mhd_FB_acc: Dict = {}
        # flux register: the coarse side (CrseInit)
        f_coarse = [f * dt for f in fluxes]
        fine_acc = None
        f_coarse_rad_dt = fine_acc_rad = None
        if self._has_rad:
            f_coarse_rad_dt = [self._rad_face_pad(rad_fluxes[d], d) * dt
                               for d in range(self.dim)]
        # composite gravity: this level's old and new phi bracket the
        # subcycle, the fine windows taking Dirichlet data at each substep's
        # midpoint; the new phi carries the delta-phi sync correction
        # (Gravity::gravity_sync)
        phi_old = phi_new = None
        if self._has_poisson:
            phi_old = self._solve_phi(l, self.u_old[l])
            phi_new = self._solve_phi_sync(l, self.u[l])
        extras = self.extra[l + 1]
        fine_acc_extra = [None] * len(extras)
        r = self.ref_ratio
        for i in range(r):
            frac0 = i / r
            fm = (i + 0.5) / r  # the substep's midpoint
            if phi_old is not None:
                phi_mid = (1.0 - fm) * phi_old + fm * phi_new
                self._cur_grav_bc[l + 1] = self._window_face_bc(l + 1, phi_mid)
                for e in extras:
                    e["grav_bc"] = self._window_face_bc(l + 1, phi_mid,
                                                        win=(e["ilo"], e["shape"]))
            if self._has_rad:
                Er_mid = (1.0 - fm) * self.u_rad_old[l] + fm * self.u_rad[l]
                self._cur_rad_bc[l + 1] = self._window_face_bc(l + 1, Er_mid,
                                                               cax=self._rad_cax)
                self._set_unmasked_rad_from_coarse(l + 1, frac0)
            if self._has_mhd:
                self._set_unmasked_b_from_coarse(l + 1, frac0)
            self._set_unmasked_from_coarse(l + 1, frac0 + 0.0)
            fine_fluxes, fine_rad = self._advance_level(l + 1, dt / r, t_level + i * dt / r)
            if self._has_mhd:
                self._ct_fine_register(l + 1, fine_rad, dt / r, mhd_E_acc, mhd_FB_acc)
            if fine_acc is None:
                fine_acc = [torch.zeros_like(coarsen_flux(fine_fluxes[d], d, self.dim))
                            for d in range(self.dim)]
            for d in range(self.dim):
                fine_acc[d] = fine_acc[d] + coarsen_flux(fine_fluxes[d], d, self.dim) * (dt / r)
            del fine_fluxes
            if self._has_rad:
                frc = [coarsen_flux(self._rad_face_pad(fine_rad[d], d), d, self.dim,
                                    comp_axes=self._rad_cax) * (dt / r)
                       for d in range(self.dim)]
                fine_acc_rad = frc if fine_acc_rad is None else \
                    [a + b for a, b in zip(fine_acc_rad, frc)]
                del fine_rad
            # the extra windows: ring fill, advance, accumulate, one by one (the
            # JAX package's _advance_extras_batch steps equal shapes as one batch)
            for e in extras:
                e["u"] = self._ring_fill(l + 1, frac0, (e["ilo"], e["shape"]), e["u"],
                                         e["mask"])
            for kx, e in enumerate(extras):
                fl_e = self._advance_extra(l + 1, e, dt / r, t_level + i * dt / r)
                fc = [coarsen_flux(fl_e[d], d, self.dim) * (dt / r) for d in range(self.dim)]
                fine_acc_extra[kx] = (fc if fine_acc_extra[kx] is None
                                      else [a + b for a, b in zip(fine_acc_extra[kx], fc)])
        self._set_unmasked_from_coarse(l + 1, 1.0)
        for e in extras:
            e["u"] = self._ring_fill(l + 1, 1.0, (e["ilo"], e["shape"]), e["u"], e["mask"])
        if self._has_rad:
            self._set_unmasked_rad_from_coarse(l + 1, 1.0)
        if self._has_mhd:
            self._set_unmasked_b_from_coarse(l + 1, 1.0)
            # the CT register first: the gas avgDown's MHD clean takes the
            # corrected coarse faces
            self._ct_correct_coarse(l, aux, mhd_E_acc, mhd_FB_acc, dt)
        # reflux (FluxRegister::Reflux): correct the unrefined coarse cells
        # beside the window with (sum of fine flux dt) - (coarse flux dt)
        self._reflux(l, f_coarse, fine_acc)
        # avgDown: covered coarse cells from the fine average
        self._avg_down(l)
        for kx, e in enumerate(extras):
            self._reflux(l, f_coarse, fine_acc_extra[kx], fwin=(e["ilo"], e["shape"]),
                         fmask=e["mask"])
            self._avg_down(l, fwin=(e["ilo"], e["shape"]), fmask=e["mask"], fu=e["u"])
        if self._has_rad:
            # the deferred sync: the mismatch feeds level l's next implicit
            # solve (Radiation::deferred_sync)
            self._rad_sync_rhs[l] = self._rad_reflux_rhs(l, f_coarse_rad_dt, fine_acc_rad)
            self._rad_avg_down(l)

    # ---------------------------------------------------------- radiation AMR
    def _set_unmasked_rad_from_coarse(self, l, frac):
        """A window's ring Er := the prolonged, time-interpolated coarse Er
        (the radiation FillPatch; per group when multigroup)."""
        self.u_rad[l] = torch.where(self.masks[l], self.u_rad[l], self._prolong_rad(l, frac=frac))

    def _rad_reflux_rhs(self, l, f_coarse_dt, fine_acc):
        """The deferred-sync rhs of level l's next implicit solve: the
        time-integrated coarse-fine radiation-flux mismatch scattered into
        the unrefined cells beside the window (reference
        Radiation::deferred_sync, the scaled FluxRegister::Reflux into the
        solve's rhs, the scale dt_old/dt taken as 1)."""
        sim = self._sims_at(l)
        dim = self.dim
        cax = self._rad_cax
        cx = (slice(None),) * cax
        csl = self._parent_rel_slice(l + 1)
        cmask = restrict_mask(self.masks[l + 1], dim)
        rhs = torch.zeros_like(self.u_rad[l])
        win = rhs[cx + csl]
        for d in range(dim):
            fsl = tuple(slice(s.start, s.stop + 1) if k == d else s for k, s in enumerate(csl))
            delta = fine_acc[d] - f_coarse_dt[d][cx + fsl]
            m_left = _pad_false(cmask, d, 1, 0)
            m_right = _pad_false(cmask, d, 0, 1)
            inv_dx = 1.0 / sim.geom.dx[d]
            zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
            gain_r = torch.where(m_left & ~m_right, delta, zero)
            lose_l = torch.where(~m_left & m_right, delta, zero)
            k = delta.shape[cax + d]
            win = win + inv_dx * gain_r.narrow(cax + d, 0, k - 1)
            win = win - inv_dx * lose_l.narrow(cax + d, 1, k - 1)
        return _set(rhs, cx + csl, win)

    def _rad_avg_down(self, l):
        """Covered level-l Er := the average of its level-(l+1) children."""
        cx = (slice(None),) * self._rad_cax
        csl = self._parent_rel_slice(l + 1)
        cmask = restrict_mask(self.masks[l + 1], self.dim)
        c_from_f = restrict(self.u_rad[l + 1], self.dim, comp_axes=self._rad_cax)
        self.u_rad[l] = _set(self.u_rad[l], cx + csl,
                             torch.where(cmask, c_from_f, self.u_rad[l][cx + csl]))

    # ---------------------------------------------------------- MHD AMR (CT)
    def _coarse_b_win(self, l, frac, win=None):
        """The parent's face fields, time-interpolated at `frac`, over
        level l's window footprint (parent-local), with one more face along
        each normal for `prolong_face`'s mid-plane faces. Components >= dim
        are cell-represented (2D Bz, 1D By and Bz)."""
        csl = self._parent_rel_slice(l, win=win)
        ng, dim = self.ng, self.dim
        out = []
        for d in range(3):
            b_new = self.u_b[l - 1][d]
            b_old = self.u_b_old[l - 1][d] if self.u_b_old[l - 1] is not None else b_new
            bi = (1.0 - frac) * b_old + frac * b_new
            sl = tuple(slice(csl[a].start + ng, csl[a].stop + ng + (1 if a == d else 0))
                       for a in range(dim))
            out.append(bi[sl])
        return out

    def _prolong_b_win(self, l, frac, win=None):
        """The window's fine interior faces, prolonged divergence-free from
        the time-interpolated coarse faces (the face FillPatch: each fine
        octant's divergence is its parent's, so zero stays zero)."""
        bc = self._coarse_b_win(l, frac, win=win)
        return [prolong_face(bc[d], d, self.dim) if d < self.dim
                else prolong(bc[d], self.dim, comp_axes=0) for d in range(3)]

    def _prolong_window_b(self, l, win=None):
        """A whole window's face field from the coarse level, filled (a
        regrid's window; the covered coarse faces carry the fine data
        through the CT register)."""
        shape = (win if win is not None else self.window[l])[1]
        pads = [self.ng, self.ng] * self.dim
        fine = [torch.nn.functional.pad(f, pads) for f in self._prolong_b_win(l, 1.0, win=win)]
        return self._get_level(l, shape).sim.mhd.fill_b_all(tuple(fine))

    def _set_unmasked_b_from_coarse(self, l, frac):
        """The window's ring faces := the prolonged, time-interpolated coarse
        faces (the face FillPatch). Only faces with no masked cell beside
        them: a face beside a masked cell is the fine CT evolution's, so the
        masked interior's div B is never touched."""
        dim, ng = self.dim, self.ng
        fine = self._prolong_b_win(l, frac)
        m = self.masks[l]
        isl = tuple(slice(ng, ng + s) for s in self.window[l][1])
        b = list(self.u_b[l])
        for d in range(3):
            if d < dim:
                mp = _pad_false(m, d, 1, 0)
                n = m.shape[d]
                adj = mp.narrow(d, 0, n) | mp.narrow(d, 1, n)
            else:
                adj = m
            b[d] = _set(b[d], isl, torch.where(adj, b[d][isl], fine[d]))
        self.u_b[l] = self._get_level(l, self.window[l][1]).sim.mhd.fill_b_all(tuple(b))

    def _ct_fine_register(self, l_fine, ct_f, dt_f, acc_E, acc_FB):
        """One fine substep's CT data (edge EMFs, cell-B fluxes) restricted
        to the parent's edges and faces over the window footprint, times
        dt_f, accumulated (FluxRegister::FineAdd for CT)."""
        dim, ng = self.dim, self.ng
        nw = self.window[l_fine][1]
        for k, Ef in ct_f["E"].items():
            sl = tuple(slice(ng, ng + nw[a] + (0 if a == k else 1)) for a in range(dim))
            r = restrict_edge(Ef[sl], k, dim) * dt_f
            acc_E[k] = r if k not in acc_E else acc_E[k] + r
        for key, Ff in (ct_f.get("FB") or {}).items():
            sl = tuple(slice(ng, ng + nw[a] + (1 if a == key[0] else 0)) for a in range(dim))
            r = restrict_face(Ff[sl], key[0], dim) * dt_f
            acc_FB[key] = r if key not in acc_FB else acc_FB[key] + r

    def _ct_correct_coarse(self, l, ct_c, acc_E, acc_FB, dt):
        """The CT flux register's correction of level l's face field: b +=
        curl(dE dt), dE = the accumulated fine-edge EMF integrals less the
        coarse EMF times dt on the coarse edges beside a covered cell, zero
        elsewhere. The discrete div(curl) vanishes, so the correction makes
        no divergence anywhere; on the covered faces the fine CT updates
        telescope and it equals the fine-face restriction (avgDown), on the
        uncovered interface faces it is the EMF reflux (Balsara's
        divergence-free AMR in one formula; reference FluxRegister + EMF
        consistency, Source/mhd/Castro_mhd.cpp). The cell-represented
        components (2D Bz) reflux and average down as conserved scalars."""
        dim, ng = self.dim, self.ng
        sim = self._sims_at(l)
        n = tuple(self.geom_full[l].n_cell) if l == 0 else self.window[l][1]
        csl = self._parent_rel_slice(l + 1)
        cmask = restrict_mask(self.masks[l + 1], dim)
        b = list(self.u_b[l])

        for k, Ef_int in acc_E.items():
            Ec = ct_c["E"][k]  # the grown level-l edge array
            sl = tuple(slice(csl[a].start + ng, csl[a].stop + ng + (0 if a == k else 1))
                       for a in range(dim))
            dE = Ef_int - dt * Ec[sl]
            # the edge mask: a covered cell beside the edge in its plane
            axes = [a for a in range(dim) if a != k]
            mp = cmask
            for a in axes:
                mp = _pad_false(mp, a, 1, 1)
            adj = None
            for offs in itertools.product((0, 1), repeat=len(axes)):
                v = mp
                for a, o in zip(axes, offs):
                    v = v.narrow(a, o, cmask.shape[a] + 1)
                adj = v if adj is None else (adj | v)
            dE = torch.where(adj, dE, 0.0)
            # into a whole-level edge field, zero elsewhere, so that the
            # faces just outside the footprint get their edge terms too
            dE_full = torch.zeros(tuple(n[a] + (0 if a == k else 1) for a in range(dim)),
                                  dtype=dE.dtype, device=dE.device)
            dE_full[tuple(slice(csl[a].start, csl[a].start + dE.shape[a])
                          for a in range(dim))] = dE
            for c in axes:
                t = 3 - c - k
                if c >= dim or t >= dim:
                    continue
                m_ = dE_full.shape[t]
                diff = dE_full.narrow(t, 1, m_ - 1) - dE_full.narrow(t, 0, m_ - 1)
                upd = -EPS[(c, t, k)] * diff / sim.geom.dx[t]
                fsl = tuple(slice(ng, ng + n[a] + (1 if a == c else 0)) for a in range(dim))
                b[c] = _set(b[c], fsl, b[c][fsl] + upd)

        # the cell-represented components: the flux reflux on the interface
        # cells, avgDown on the covered cells
        cells = tuple(slice(ng, ng + n[a]) for a in range(dim))
        for c in range(dim, 3):
            bc_int = b[c][cells]
            win_v = bc_int[csl]
            for d in range(dim):
                key = (d, c)
                if key not in acc_FB:
                    continue
                Fc = ct_c["FB"][key]
                fsl = tuple(slice(csl[a].start + ng, csl[a].stop + ng + (1 if a == d else 0))
                            for a in range(dim))
                delta = acc_FB[key] - dt * Fc[fsl]
                m_left = _pad_false(cmask, d, 1, 0)
                m_right = _pad_false(cmask, d, 0, 1)
                inv_dx = 1.0 / sim.geom.dx[d]
                gain_r = torch.where(m_left & ~m_right, delta, 0.0)
                lose_l = torch.where(~m_left & m_right, delta, 0.0)
                k_ = delta.shape[d]
                win_v = win_v + inv_dx * gain_r.narrow(d, 0, k_ - 1)
                win_v = win_v - inv_dx * lose_l.narrow(d, 1, k_ - 1)
            fine_c = restrict(self.u_b[l + 1][c][tuple(slice(ng, ng + s)
                                                       for s in self.window[l + 1][1])],
                              dim, comp_axes=0)
            win_v = torch.where(cmask, fine_c, win_v)
            b[c] = _set(b[c], cells, _set(bc_int, csl, win_v))
        self.u_b[l] = self._sims_at(l).mhd.fill_b_all(tuple(b))

    def _advance_extra(self, l, e, dt, t_level):
        """Advance one extra window by dt (the same per-shape Simulation
        cache as the primary). Returns its interior face fluxes."""
        lev = self._get_level(l, e["shape"])
        out = lev.step(e["u"], dt, t_level, e["ilo"], grav_bc=e.get("grav_bc"))
        self._check(out, f"(extra window) at level {l}, t={t_level}")
        e["u"] = self._keep_masked(e["u"], out[0], e["mask"])
        return out[3]

    # ------------------------------------------------------------ composite phi
    def _solve_phi(self, l, u_l):
        """Level l's phi from u_l's density with the level's current
        boundary data: the domain's multipole (or periodic) BCs at level 0,
        a window's coarse-interpolated Dirichlet faces above it."""
        rho = u_l[(self._sims_at(l).layout.URHO,) + interior_slice(self.ng, self.dim, 0)]
        if l == 0:
            return self._grav0._poisson(rho)[1]
        lev = self._get_level(l, self.window[l][1])
        return lev.phi(rho, self.window[l][0], self._cur_grav_bc.get(l))

    def _solve_phi_sync(self, l, u_l):
        """The composite delta-phi sync (reference Gravity::gravity_sync,
        `Gravity.cpp:488-631`, with the phi flux register of
        `Castro.cpp:2727-2760`), one pass: the level solve, the fine
        window's Dirichlet solve against it, the grad-phi flux-register
        mismatch at the coarse-fine interface as a rhs, a Poisson solve for
        delta-phi, and the corrected coarse phi. phi is solved from the
        current (post-reflux, post-avgDown) density, so the reference's
        4 pi G drho term is absorbed and the register carries the composite
        solve's flux mismatch alone; its largest magnitude is kept as
        `phi_sync_resid`. Iterated, the pass does not contract
        (castro_tpu/driver/amr.py:856-866): one pass, as in JAX."""
        phi_c = self._solve_phi(l, u_l)
        if l != 0 or l + 1 > self.max_level:
            return phi_c
        lev = self._get_level(l + 1, self.window[l + 1][1])
        if lev.grav is None:
            return phi_c
        L = self.sim0.layout
        rho_f = self.u[l + 1][(L.URHO,) + interior_slice(self.ng, self.dim, 0)]
        phi_f = lev.phi(rho_f, self.window[l + 1][0], self._window_face_bc(l + 1, phi_c))
        rhs = self._phi_flux_register(l, phi_c, phi_f)
        self.phi_sync_resid = float(rhs.abs().max())
        # the delta solve: the level Poisson machinery with the equivalent
        # delta density rhs / (4 pi G) (the multipole BCs of the delta
        # density are the reference's fill_multipole_BCs of its rhs)
        dphi = self._grav0._poisson(rhs / (4.0 * np.pi * C.Gconst))[1]
        return phi_c + dphi

    def _phi_flux_register(self, l, phi_c, phi_f):
        """The grad-phi coarse-fine flux register of the sync: rhs =
        -div(grad phi_fine - grad phi_crse) at the level-(l+1) window's
        interface, in the hydro reflux's sign convention (CrseInit(-grad
        phi_crse) + FineAdd(grad phi_fine) -> Reflux; reference
        `Castro.cpp:2727-2760`)."""
        dim = self.dim
        sim = self._sims_at(l)
        csl = self._parent_rel_slice(l + 1)
        cmask = restrict_mask(self.masks[l + 1], dim)
        rhs = torch.zeros_like(phi_c)
        win = rhs[csl]
        for d in range(dim):
            dx_c = sim.geom.dx[d]
            dx_f = self._sims_at(l + 1).geom.dx[d]
            # the coarse face gradients over the footprint's n_fp + 1 faces
            fsl = tuple(slice(s.start, s.stop + 1) if k == d else s for k, s in enumerate(csl))
            pc = _edge_pad(phi_c, d)
            n = pc.shape[d]
            Fc = ((pc.narrow(d, 1, n - 1) - pc.narrow(d, 0, n - 1)) / dx_c)[fsl]
            # the fine face gradients restricted to the footprint's faces
            # (the edge faces are garbage, masked off: the interface faces
            # are interior)
            pf = _edge_pad(phi_f, d)
            n = pf.shape[d]
            Ff_fine = (pf.narrow(d, 1, n - 1) - pf.narrow(d, 0, n - 1)) / dx_f
            m = Ff_fine.shape[d]
            # n_fp faces, then the footprint's hi face
            Ff = torch.cat([restrict_face(Ff_fine.narrow(d, 0, m - 1), d, dim),
                            restrict_face(Ff_fine.narrow(d, m - 1, 1), d, dim)], dim=d)
            delta = Ff - Fc
            m_left = _pad_false(cmask, d, 1, 0)
            m_right = _pad_false(cmask, d, 0, 1)
            zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
            gain_r = torch.where(m_left & ~m_right, delta, zero)
            lose_l = torch.where(~m_left & m_right, delta, zero)
            k = delta.shape[d]
            win = win + gain_r.narrow(d, 0, k - 1) / dx_c
            win = win - lose_l.narrow(d, 1, k - 1) / dx_c
        return _set(rhs, csl, win)

    def _window_face_bc(self, l, phi_c, win=None, cax=0):
        """Dirichlet values of a cell field on a level-l window's faces,
        linearly interpolated from the parent level's field phi_c (the
        parent's interior, with `cax` leading component axes, a multigroup
        Er's group axis): the coarse-phi boundary registers of composite
        gravity (Gravity.cpp:418-487) and the coarse-Er boundary data of AMR
        radiation (RadBndry). JAX's map_coordinates(order=1,
        mode="nearest") written out: the coordinate's floor and the next
        index, each clamped to [0, n-1], with linear weights."""
        ilo, shape = win if win is not None else self.window[l]
        base_c = (np.zeros(self.dim, int) if l - 1 == 0
                  else np.asarray(self.window[l - 1][0], int))
        bvl, bvh = [], []
        for d in range(self.dim):
            for side in ("lo", "hi"):
                vals = phi_c
                for k in range(self.dim):
                    if k == d:
                        xf = int(ilo[d]) if side == "lo" else int(ilo[d]) + shape[d]
                        x = np.asarray([xf / 2.0 - 0.5 - base_c[d]])
                    else:
                        i = np.arange(int(ilo[k]), int(ilo[k]) + shape[k])
                        x = (i + 0.5) / 2.0 - 0.5 - base_c[k]
                    vals = _lerp_axis(vals, cax + k, x)
                (bvl if side == "lo" else bvh).append(vals)
        return (tuple(bvl), tuple(bvh))

    def _reflux(self, l, f_coarse, fine_acc, fwin=None, fmask=None):
        """fine_acc: the window-coarsened sums of fine flux dt (over the
        level-(l+1) window's coarse footprint); f_coarse: the coarse level's
        flux dt. The corrections lie inside the window's footprint; the
        directions are applied in order 0, 1, 2."""
        sim = self._sims_at(l)
        dim = self.dim
        csl = self._parent_rel_slice(l + 1, win=fwin)
        cmask = restrict_mask(fmask if fmask is not None else self.masks[l + 1], dim)
        idx = interior_slice(self.ng, dim)
        u_int = self.u[l][idx]
        win = u_int[(slice(None),) + csl]
        for d in range(dim):
            # coarse flux faces over the window footprint (n_win+1 along d)
            fsl = [slice(None)]
            for k in range(dim):
                s = csl[k]
                fsl.append(slice(s.start, s.stop + 1) if k == d else s)
            delta = fine_acc[d] - f_coarse[d][tuple(fsl)]
            m_left = _pad_false(cmask, d, 1, 0)
            m_right = _pad_false(cmask, d, 0, 1)
            inv_dx = 1.0 / sim.geom.dx[d]
            zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
            gain_r = torch.where((m_left & ~m_right)[None], delta, zero)
            lose_l = torch.where((~m_left & m_right)[None], delta, zero)
            sl_hi = [slice(None)] * delta.dim()
            sl_hi[1 + d] = slice(1, None)
            sl_lo = [slice(None)] * delta.dim()
            sl_lo[1 + d] = slice(0, -1)
            win = win + inv_dx * gain_r[tuple(sl_lo)]
            win = win - inv_dx * lose_l[tuple(sl_hi)]
        u_int = _set(u_int, (slice(None),) + csl, win)
        self.u[l] = _set(self.u[l], idx, u_int)

    def _avg_down(self, l, fwin=None, fmask=None, fu=None):
        """Covered level-l cells := the average of their level-(l+1)
        children, then level l's clean + fill (the default route)."""
        dim = self.dim
        csl = self._parent_rel_slice(l + 1, win=fwin)
        cmask = restrict_mask(fmask if fmask is not None else self.masks[l + 1], dim)
        f_int = (fu if fu is not None else self.u[l + 1])[interior_slice(self.ng, dim)]
        c_from_f = restrict(f_int, dim)
        idx = interior_slice(self.ng, dim)
        u_int = self.u[l][idx]
        blk = torch.where(cmask[None], c_from_f, u_int[(slice(None),) + csl])
        u_int = _set(u_int, (slice(None),) + csl, blk)
        u = _set(self.u[l], idx, u_int)
        sim = self.sim0 if l == 0 else self._get_level(l, self.window[l][1]).sim
        # MHD: the MHD clean, its energy reset against the level's faces
        self.u[l] = sim.mhd._clean(u, self.u_b[l]) if self._has_mhd else sim._clean_fill_impl(u)

    def advance(self, dt):
        """Advance the whole hierarchy by dt with retry (reference
        retry_advance_ctu lifted to the hierarchy: on any level's failure,
        restore the pre-step hierarchy and re-run it subcycled)."""
        c = self.params.castro
        # the level arrays are never written in place, so references are a
        # snapshot
        snap_u = list(self.u)
        snap_masks = list(self.masks)
        snap_rad = list(self.u_rad)
        snap_b = list(self.u_b)
        snap_sync = dict(self._rad_sync_rhs)
        snap_extra = [[dict(e) for e in lvl] for lvl in self.extra]

        def restore():
            self.u = list(snap_u)
            self.masks = list(snap_masks)
            self.u_rad = list(snap_rad)
            self.u_b = list(snap_b)
            self._rad_sync_rhs = dict(snap_sync)
            self.extra = [[dict(e) for e in lvl] for lvl in snap_extra]

        try:
            self._advance_level(0, dt, self.t)
            self.t += dt
            self._count_zones(1)
            return dt
        except RuntimeError:
            if not c.use_retry:
                raise

        dt_sub = dt * c.retry_subcycle_factor
        for _ in range(c.max_subcycles):
            restore()
            t_adv = 0.0
            nsub = 0
            try:
                while t_adv < dt * (1 - 1e-12):
                    step = min(dt_sub, dt - t_adv)
                    self._advance_level(0, step, self.t + t_adv)
                    t_adv += step
                    nsub += 1
                self.t += dt
                self._count_zones(nsub)
                return dt
            except RuntimeError:
                dt_sub *= c.retry_subcycle_factor
                if dt_sub < c.dt_cutoff:
                    break
        restore()
        raise RuntimeError(f"AMR advance failed at t={self.t}: dt_sub={dt_sub} below cutoff")

    def _count_zones(self, nsub):
        """Zones a coarse step advances: level 0 and every window, each
        window ref_ratio^l times (subcycling)."""
        zones = int(np.prod(self.sim0.geom.n_cell))
        for l in range(1, self.max_level + 1):
            zones += int(np.prod(self.window[l][1])) * self.ref_ratio ** l
            for e in self.extra[l]:
                zones += int(np.prod(e["shape"])) * self.ref_ratio ** l
        self.num_zones_advanced += zones * nsub
        return zones

    # ------------------------------------------------------------------ loop
    def run(self, max_step=None, stop_time=None, verbose=None):
        """The coarse-timestep loop with regrids every amr.regrid_int steps;
        prints STEP lines with `verbose`. Output raises (`check_io_cadence`)."""
        a = self.params.amr
        max_step = max_step if max_step is not None else (
            a.max_step if a.max_step >= 0 else 10 ** 9)
        stop_time = stop_time if stop_time is not None else (
            a.stop_time if a.stop_time >= 0 else np.inf)
        verbose = self.params.castro.v if verbose is None else verbose
        check_io_cadence(self.params)
        if self.u[0] is None:
            self.init_data()
        while self.step_count < max_step and self.t < stop_time * (1 - 1e-12):
            if (a.regrid_int > 0 and self.step_count > 0
                    and self.step_count % a.regrid_int == 0):
                self.regrid()
            dt = self.estimate_dt()
            if self.t + dt > stop_time:
                dt = stop_time - self.t
            self.advance(dt)
            self.dt = dt
            self.step_count += 1
            if verbose:
                nref = int(self.masks[1].sum()) if self.max_level > 0 else 0
                win = self.window[1][1] if self.max_level > 0 else ()
                print(f"STEP {self.step_count} t={self.t:.6e} dt={dt:.6e} "
                      f"refined_cells_l1={nref} window_l1={win}")
        return self

    # ------------------------------------------------------------------ views
    def interior(self, l=0):
        return self.u[l][interior_slice(self.ng, self.dim)]

    def composite_interior(self):
        """The finest data available, represented on the finest grid."""
        out = self.interior(0)
        for l in range(1, self.max_level + 1):
            out = prolong(out, self.dim, conservative=False)
            wins = [(self.window[l], self.u[l], self.masks[l])] + [
                ((e["ilo"], e["shape"]), e["u"], e["mask"]) for e in self.extra[l]]
            for (ilo, shape), u_w, m_w in wins:
                fine = u_w[interior_slice(self.ng, self.dim)]
                blk_sl = (slice(None),) + tuple(
                    slice(int(ilo[k]), int(ilo[k]) + shape[k]) for k in range(self.dim))
                out = _set(out, blk_sl, torch.where(m_w[None], fine, out[blk_sl]))
        return out
