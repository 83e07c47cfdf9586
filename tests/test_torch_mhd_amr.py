"""MHD on two-level AMR (`driver/amr.py`: the face fields a level, the
divergence-free face fillpatch, the CT flux register, the MHD clean of
avgDown and of a regridded window) against the JAX package's hierarchy
(tests/test_mhd_amr.py's setups): Orszag-Tang at 32^2 + 1 level over a
static central box, two coarse steps (each with two subcycled window
steps), the state, the face fields of each level, the windows and the
masks; and the hierarchy carried across (`convert.hierarchy_to_numpy` /
`restore_hierarchy`, face fields included) and stepped in both packages.
div B stays below 1e-10 on both levels' valid regions, and the covered
coarse faces track the fine faces' restriction (tests/test_mhd_amr.py's
bound). The regrid and a uniform field: tests/test_torch_mhd_amr_regrid.py.

The JAX side runs op by op (`jax.disable_jit()`; jitted, its level steps
compile for ~50 s). Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per
state component, the momenta and the face fields each sharing their
vector's largest magnitude (`tests/test_torch_radiation.py:close`).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import orszag_tang as jot

from castro_tpu_torch import convert
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.ops.interlevel import restrict_face, restrict_mask
from castro_tpu_torch.ops.stencil import interior_slice
from castro_tpu_torch.problems import orszag_tang as tot

from test_torch_radiation import _few_threads, close  # noqa: F401

jax.config.update("jax_enable_x64", True)


def _jinit(sim, u, b):
    """The JAX package's Orszag-Tang data on a Simulation or a window
    (its problem_init reads sim.base)."""
    return jot.problem_init(types.SimpleNamespace(base=sim), u, b)


def _jtag(sim, u_int, level):
    x = jnp.asarray(sim.geom.cell_centers(0, 0))
    y = jnp.asarray(sim.geom.cell_centers(1, 0))
    return (x > 0.3) & (x < 0.7) & (y > 0.3) & (y < 0.7) & jnp.ones(u_int.shape[1:], bool)


def _ttag(sim, u_int, level):
    x = sim.geom.cell_centers(0, 0)
    y = sim.geom.cell_centers(1, 0)
    return ((x > 0.3) & (x < 0.7) & (y > 0.3) & (y < 0.7)).expand(u_int.shape[1:])


def _params(mod, n=32, **amr):
    return mod.make_params(n=n).with_ns("amr", max_level=1, regrid_int=0, n_error_buf=2, **amr)


def divb_max(amr, l):
    """max |div B| over level l's valid region (masked cells above 0)."""
    div = amr._sims_at(l).mhd.div_b(amr.u_b[l])[interior_slice(amr.ng, amr.dim, 0)]
    if l > 0:
        div = torch.where(amr.masks[l], div, 0.0)
    return float(div.abs().max())


def covered_faces_err(amr):
    """max |restricted fine face - coarse face| over the coarse faces with
    both cells covered (tests/test_mhd_amr.py)."""
    ng, dim = amr.ng, amr.dim
    csl = amr._parent_rel_slice(1)
    cmask = restrict_mask(amr.masks[1], dim)
    worst = 0.0
    for d in range(dim):
        fine = amr.u_b[1][d][tuple(slice(ng, ng + s + (1 if a == d else 0))
                                   for a, s in enumerate(amr.window[1][1]))]
        rf = restrict_face(fine, d, dim)
        coarse = amr.u_b[0][d][tuple(slice(s.start + ng, s.stop + ng + (1 if a == d else 0))
                                     for a, s in enumerate(csl))]
        n = cmask.shape[d]
        inner = cmask.narrow(d, 0, n - 1) & cmask.narrow(d, 1, n - 1)
        worst = max(worst, float((rf.narrow(d, 1, n - 1) - coarse.narrow(d, 1, n - 1))
                                 .abs()[inner].max()))
    return worst


def check_levels(ta, ja):
    L = ta.sim0.layout
    for l in range(2):
        assert tuple(ta.window[l][1]) == tuple(ja.window[l][1])
        assert np.array_equal(np.asarray(ta.window[l][0]), np.asarray(ja.window[l][0]))
        np.testing.assert_array_equal(ta.masks[l].numpy(), np.asarray(ja.masks[l]))
        close(ta.interior(l), np.asarray(ja.interior(l)), what=f"u level {l}",
              vectors=[(L.UMX, L.UMY, L.UMZ)])
        isl = (slice(ta.ng, -ta.ng),) * ta.dim
        close(torch.stack([bb[isl] for bb in ta.u_b[l]]),
              np.stack([np.asarray(bb)[isl] for bb in ja.u_b[l]]), what=f"face B level {l}",
              vectors=[(0, 1, 2)])
        assert divb_max(ta, l) < 1e-10, (l, divb_max(ta, l))


def test_two_level_orszag_tang_against_jax():
    """Two coarse steps from the same data in both packages; then the JAX
    hierarchy after its first step carried into the port and stepped once
    more in both."""
    ja = JAmr(_params(jot), problem_init=_jinit, problem_tagging=_jtag)
    ta = AmrSimulation(_params(tot), problem_init=tot.problem_init, problem_tagging=_ttag,
                       device="cpu")
    with jax.disable_jit():
        ja.init_data()
        ta.init_data()
        assert int(ta.masks[1].sum()) > 0
        check_levels(ta, ja)
        dts = []
        for _ in range(2):
            dts.append(ja.estimate_dt())
            assert abs(ta.estimate_dt() - dts[-1]) <= 1e-12 * dts[-1]
            if len(dts) == 1:
                snap = convert.hierarchy_to_numpy(ja)
            ja.advance(dts[-1])
            ta.advance(dts[-1])
    check_levels(ta, ja)
    assert covered_faces_err(ta) < 5e-3
    # the hierarchy carried across, face fields included
    tb = AmrSimulation(_params(tot), problem_init=tot.problem_init, problem_tagging=_ttag,
                       device="cpu")
    convert.restore_hierarchy(tb, snap)
    tb.advance(dts[0])
    tb.advance(dts[1])
    check_levels(tb, ja)
    hydro = AmrSimulation(_params(tot).with_ns("castro", do_mhd=0), device="cpu")
    with pytest.raises(ValueError, match="do_mhd"):
        convert.restore_hierarchy(hydro, snap)
