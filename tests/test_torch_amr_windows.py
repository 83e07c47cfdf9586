"""The port's AMR windows against the JAX package's, on the CPU, in 2D:
the tag clustering, and two separated blobs that get a window each
(tests/test_multiwindow_amr.py at 32^2). Float64 with jit disabled on the
JAX side;
equal windows and masks, level states to rtol 1e-10
(tests/test_torch_amr.py:assert_same_hierarchy).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.driver.amr import _cluster_tags as j_cluster_tags
from castro_tpu.problems.util import fill_from_prim as jfill

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.amr import AmrSimulation, _cluster_tags
from castro_tpu_torch.problems.util import fill_from_prim
from test_torch_amr import _few_threads, assert_same_hierarchy, step_both  # noqa: F401


def _two_blob_params(P, n=32):
    p = P()
    p = p.with_ns("amr", n_cell=(n, n), max_level=1, regrid_int=2, n_error_buf=1,
                  refinement_indicators=("dens",))
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", lo_bc=(0, 0), hi_bc=(0, 0), small_dens=1e-8)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(extra={"amr.dens.field": "density", "amr.dens.value_greater": 1.3})


def _two_blobs(xp, fill):
    def init(sim, u):
        x = sim.geom.cell_centers(0, sim.ng)
        y = sim.geom.cell_centers(1, sim.ng)
        r1 = xp.sqrt((x - 0.22) ** 2 + (y - 0.22) ** 2)
        r2 = xp.sqrt((x - 0.78) ** 2 + (y - 0.78) ** 2)
        rho = 1.0 + 1.0 * xp.exp(-(r1 / 0.06) ** 2) + 1.0 * xp.exp(-(r2 / 0.06) ** 2)
        return fill(sim, u, rho, (0.0, 0.0, 0.0), p=1.0)
    return init


def _check_clusters(t, gap):
    got, ref = _cluster_tags(t, merge_gap=gap), j_cluster_tags(t, merge_gap=gap)
    assert len(got) == len(ref)
    for (lo, hi), (jlo, jhi) in zip(got, ref):
        assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)


@pytest.mark.parametrize("tags", [
    [((4, 8), (4, 8)), ((24, 28), (24, 28))],
    [((4, 8), (4, 8)), ((9, 12), (9, 12))],
    [((1, 3), (20, 30)), ((12, 14), (2, 5)), ((25, 31), (25, 27))],
])
def test_cluster_tags_like_jax(tags):
    t = np.zeros((32, 32), bool)
    for (a, b), (c, d) in tags:
        t[a:b, c:d] = True
    _check_clusters(t, 4)


@pytest.mark.parametrize("seed", range(12))
def test_cluster_tags_like_jax_on_random_tags(seed):
    """Random tag arrays of one to three dimensions and densities from
    sparse to percolating: the same components, boxes and order."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        shape = tuple(int(n) for n in rng.integers(1, 20, size=rng.integers(1, 4)))
        _check_clusters(rng.random(shape) < rng.uniform(0.02, 0.6), int(rng.integers(0, 5)))


def test_two_blobs_two_windows_like_jax():
    """Each blob gets its own window; four coarse steps with a regrid, the
    extra window stepped, refluxed and averaged down as in JAX, and the
    level-0 mass conserved from the first step on (periodic box)."""
    port = AmrSimulation(_two_blob_params(Params), problem_init=_two_blobs(torch, fill_from_prim),
                         device="cpu")
    port.init_data()
    assert len(port.extra[1]) == 1
    with jax.disable_jit():
        jamr = JAmr(_two_blob_params(JParams), problem_init=_two_blobs(jnp, jfill))
        jamr.init_data()
        assert_same_hierarchy(port, jamr, what="init")
        step_both(port, jamr, 1, dt=1e-3)
        m0 = float(port.interior(0)[0].sum())
        step_both(port, jamr, 3, regrid_int=2, dt=1e-3)
        assert_same_hierarchy(port, jamr, what="after 4 steps")
    assert len(port.extra[1]) == 1
    m1 = float(port.interior(0)[0].sum())
    assert abs(m1 - m0) / m0 < 1e-11
