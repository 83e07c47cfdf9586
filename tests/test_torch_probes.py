"""The three profiling probes' plain versions against the JAX package.

`scripts/prof_cmpflx.py` and `scripts/prof_vpu.py` run their whole profile
when imported, so this file rebuilds their kernel bodies as they are
written there (`make_cmpflx`, `make_copy`, `make`) and runs them through
`pl.pallas_call(..., interpret=True)` on the CPU, at a small grid and
without the TPU-only compiler parameters. Nothing under `scripts/` changes.

- probe_cmpflx: its plain version against `_riemann_block(..., d=0,
  solver 0)` called directly and under a Pallas grid of (8, 8) and (8,)
  row tiles, float32, coord 0 and 2;
- probe_copy: against the Pallas copy body, exactly;
- probe_vpu: each body's plain version against the same body in jnp under
  `lax.fori_loop`, and under a Pallas call, for a few iterations (the
  approximate reciprocal against the exact one, see JAX_BODIES);
- the probes' input setup (Sedov, ctoprim, flattening, the trace of
  direction 0 at dt = 1e-4, gamc and c rolled along x) against the JAX
  script's, at n = 8;
- both entry points run on the CPU with device=cpu and label their numbers
  as the CPU's; so do `castro_tpu_torch/scripts/prof_faces.py`, the
  port's profile of the face kernels (no JAX counterpart), every variant
  in every direction, and `scripts/prof_cells.py`, that of prim_aux and
  flatten, whose saved outputs read back equal to themselves.

Tolerances: float32 rtol = atol = 2e-5 (tests/test_pallas.py:41) for the
Riemann body and the setup; the copy is exact; a vpu body iterated k times
may differ by one rounding an iteration (XLA's CPU code may contract the
multiply-add, and its rsqrt, exp and approximate reciprocal are its own),
so rtol = k * 2^-22 there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.ops.advection_util import ctoprim as j_ctoprim
from castro_tpu.ops.flatten import uflatten as j_uflatten
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import sedov as jsedov
from castro_tpu.state import StateLayout as JLayout

from castro_tpu_torch.ops import probes as P
from castro_tpu_torch.scripts import prof_cells, prof_cmpflx, prof_faces, prof_vpu
from castro_tpu_torch.state import StateLayout

from test_torch_hydro_paths import _few_threads  # noqa: F401
from test_torch_kernels_unfused import _face_states

SMALL_DENS, SMALL_PRES = 1e-12, 1e-20
JL, TL = JLayout(dim=3, nspec=1), StateLayout(dim=3, nspec=1)


def _inputs(seed):
    """Face states and the four cell scalars on a 3D grid (SHAPES[3] of
    tests/test_torch_kernels_unfused.py), float32."""
    qm, qp, aux = _face_states(3, seed)
    return [qm, qp] + aux


def _pallas_cmpflx(tiles, coord, arrays):
    """`scripts/prof_cmpflx.py:make_cmpflx` on this grid, interpreted."""
    gshape = arrays[0].shape[1:]

    def bs(nc):
        if len(tiles) == 2:
            return pl.BlockSpec((nc, tiles[0], tiles[1], gshape[2]), lambda i, j: (0, i, j, 0))
        return pl.BlockSpec((nc, tiles[0], gshape[1], gshape[2]), lambda i: (0, i, 0, 0))

    def kernel(qm_ref, qp_ref, gl_ref, gr_ref, cl_ref, cr_ref, flux_ref, qe_ref):
        flux, qg = pk._riemann_block(qm_ref[...], qp_ref[...], gl_ref[0], gr_ref[0], cl_ref[0],
                                     cr_ref[0], 0, JL, coord, 0, SMALL_DENS, SMALL_PRES)
        flux_ref[...] = flux
        qe_ref[...] = qg

    grid = tuple(gshape[i] // tiles[i] for i in range(len(tiles)))
    out_shape = (jax.ShapeDtypeStruct((JL.NVAR,) + gshape, jnp.float32),
                 jax.ShapeDtypeStruct((JL.NGDNV,) + gshape, jnp.float32))
    qm, qp, gl, gr, cl, cr = (jnp.asarray(a) for a in arrays)
    return pl.pallas_call(kernel, grid=grid, in_specs=[bs(JL.NQ), bs(JL.NQ)] + [bs(1)] * 4,
                          out_specs=(bs(JL.NVAR), bs(JL.NGDNV)), out_shape=out_shape,
                          interpret=True)(qm, qp, gl[None], gr[None], cl[None], cr[None])


@pytest.mark.parametrize("coord", [0, 2])
def test_probe_cmpflx_plain_matches_riemann_block(coord):
    arrays = _inputs(seed=5 + coord)
    got = P.probe_cmpflx(*(torch.as_tensor(a) for a in arrays), TL, coord, SMALL_DENS,
                         SMALL_PRES)
    ref = pk._riemann_block(*(jnp.asarray(a) for a in arrays), 0, JL, coord, 0, SMALL_DENS,
                            SMALL_PRES)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=2e-5, atol=2e-5)
    for tiles in ((4, 4), (4,)):
        ref = _pallas_cmpflx(tiles, coord, arrays)
        for g_, r_ in zip(got, ref):
            np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=2e-5, atol=2e-5)
    assert P.probe_cmpflx.launches == 0  # CPU tensors take the plain version


def test_probe_copy_plain_matches_pallas_copy():
    arrays = _inputs(seed=9)
    gshape = arrays[0].shape[1:]

    def bs(nc):
        return pl.BlockSpec((nc, 4, gshape[1], gshape[2]), lambda i: (0, i, 0, 0))

    def kernel(qm_ref, qp_ref, gl_ref, gr_ref, cl_ref, cr_ref, flux_ref, qe_ref):
        flux_ref[...] = qm_ref[:JL.NVAR] + qp_ref[:JL.NVAR]
        qe_ref[...] = qm_ref[:JL.NGDNV] * 2.0

    out_shape = (jax.ShapeDtypeStruct((JL.NVAR,) + gshape, jnp.float32),
                 jax.ShapeDtypeStruct((JL.NGDNV,) + gshape, jnp.float32))
    qm, qp, gl, gr, cl, cr = (jnp.asarray(a) for a in arrays)
    ref = pl.pallas_call(kernel, grid=(gshape[0] // 4,),
                         in_specs=[bs(JL.NQ), bs(JL.NQ)] + [bs(1)] * 4,
                         out_specs=(bs(JL.NVAR), bs(JL.NGDNV)), out_shape=out_shape,
                         interpret=True)(qm, qp, gl[None], gr[None], cl[None], cr[None])
    got = P.probe_copy(torch.as_tensor(arrays[0]), torch.as_tensor(arrays[1]), TL)
    for g_, r_ in zip(got, ref):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))


# the bodies of scripts/prof_vpu.py (fma_rn has the body of fma). The
# approximate reciprocal is held against the exact one: on the CPU
# `pl.reciprocal(approx=True)` lowers to an approximation that was off by
# 0.5% here, which is neither the TPU's nor the card's (chip_smoke.py holds
# the card's rcp.approx.f32 to its plain version)
JAX_BODIES = {
    "fma": lambda x: x * 1.0000001 + 1e-9,
    "fma_rn": lambda x: x * 1.0000001 + 1e-9,
    "div": lambda x: 1.0 / (x + 1e-9),
    "rsqrt": lambda x: jax.lax.rsqrt(x) + 1.0,
    "recip_approx": lambda x: pl.reciprocal(x, approx=False) + 1e-9,
    "exp": lambda x: jnp.exp(x * 1e-9),
}


@pytest.mark.parametrize("op", P.VPU_OPS)
def test_probe_vpu_plain_matches_jax_bodies(op):
    iters = 12
    x = np.full((16, 16), 1.1, np.float32)
    x[0, :] = np.linspace(0.3, 3.0, 16, dtype=np.float32)  # a few starting points
    got = P.probe_vpu(torch.as_tensor(x), op, iters).numpy()
    body = JAX_BODIES[op]

    def kernel(x_ref, o_ref):
        o_ref[...] = jax.lax.fori_loop(0, iters, lambda i, v: body(v), x_ref[...])

    via_loop = jax.lax.fori_loop(0, iters, lambda i, v: body(v), jnp.asarray(x))
    via_pallas = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                                interpret=True)(jnp.asarray(x))
    rtol = iters * 2.0 ** -22
    np.testing.assert_allclose(got, np.asarray(via_loop), rtol=rtol, atol=0)
    np.testing.assert_allclose(got, np.asarray(via_pallas), rtol=rtol, atol=0)
    assert P.probe_vpu.launches == 0
    with pytest.raises(ValueError, match="unknown vpu op"):
        P.probe_vpu(torch.as_tensor(x), "sin", 1)


def test_probe_setup_matches_jax_script():
    """The face states and neighbour scalars of the probes against the JAX
    script's construction, at n = 8 (float32), from the JAX initial state
    (the float32 Sedov inits of the two packages differ in the ambient,
    where 1 - tanh cancels; ROADMAP.md queue 3)."""
    n = 8
    sim_t = prof_cmpflx.sedov_sim(n=n, device="cpu")
    pk.INTERPRET = True
    try:
        with jax.disable_jit():
            params = jsedov.make_params(n=n, dim=3, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                                        dtype="float32")
            sim = JSim(params, problem_init=jsedov.problem_init)
            sim.init_data()
            L, cfg = sim.layout, sim.cfg
            q, qaux = j_ctoprim(sim.u, L, sim.eos, cfg.small_dens, 1e-200)
            flatn = j_uflatten(q, L)
            qm, qp = pk.trace_ppm_pallas(q, qaux, None, flatn, 0, np.float32(1e-4),
                                         sim.geom.dx[0], L, cfg.small_dens, cfg.small_pres,
                                         cfg.small_ener)
            ref = dict(qm=qm, qp=qp, gl=jnp.roll(qaux[L.QGAMC], 1, 0), gr=qaux[L.QGAMC],
                       cl=jnp.roll(qaux[L.QC], 1, 0), cr=qaux[L.QC])
    finally:
        pk.INTERPRET = False
    x = prof_cmpflx.face_inputs(sim_t, torch.as_tensor(np.array(sim.u)))
    for key, r_ in ref.items():
        np.testing.assert_allclose(x[key].numpy(), np.asarray(r_), rtol=2e-5, atol=2e-5,
                                   err_msg=key)


def test_entry_points_run_on_the_cpu():
    lines = []
    x = prof_cmpflx.setup(n=8, device="cpu")
    res = prof_cmpflx.run(x, reps=1, out=lines.append)
    assert len(res) == 9 and all(v > 0 for v in res.values())
    res, bounds = prof_vpu.run(torch.full((8, 8), 1.1), lo=2, hi=4, out=lines.append)
    assert set(res) == set(P.VPU_OPS) and bounds is None
    assert len(lines) == 15
    assert all("[CPU, plain versions; not a device measurement]" in ln for ln in lines)
    assert prof_vpu.main(["device=cpu", "n=4", "lo=1", "hi=2"]) == 0


def test_face_profile_runs_on_the_cpu():
    """scripts/prof_faces.py: every variant of the two face kernels in every
    direction, and consup alone in every direction, each call the same
    function as its plain version."""
    x = prof_faces.setup(n=8, device="cpu")
    calls = prof_faces.variants(x)
    assert sorted({(k, v) for k, v, *_ in calls}) == sorted(
        [("trace_ppm", "with the solve"), ("trace_ppm", "without the solve"),
         ("ctu_face", "corner pair"), ("ctu_face", "final + consup"),
         ("ctu_face", "terms=[]"), ("ctu_face", "final alone")])
    assert sorted(d for *_, d, _, _, _ in calls) == [0] * 6 + [1] * 6 + [2] * 6
    flat = lambda o: [o] if isinstance(o, torch.Tensor) else [t for i in o for t in flat(i)]
    for name, variant, d, kern, plain, comps in calls:
        got, ref = flat(kern()), flat(plain())
        assert len(got) == len(ref) > 0
        for g_, r_ in zip(got, ref):
            assert torch.equal(g_, r_), (name, variant, d)
    alone = prof_faces.consup_variants(x)
    assert [d for d, *_ in alone] == [0, 1, 2]
    for d, kern, plain, comps in alone:
        assert comps == 5 * x["layout"].NVAR + 3
        for g_, r_ in zip(kern(), plain()):
            assert torch.equal(g_, r_), ("consup", d)
    lines = []
    res = prof_faces.run(x, reps=1, out=lines.append)
    assert len(res) == 21 and all(v > 0 for v in res.values())
    assert sorted(k for k in res if k[0] == "consup") == [("consup", "alone", d) for d in range(3)]
    assert all("[CPU, plain versions; not a device measurement]" in ln for ln in lines)


def test_cell_profile_runs_on_the_cpu(tmp_path):
    """scripts/prof_cells.py: prim_aux and flatten, each call the same
    function as its plain version; the outputs it saves on its two states
    compare equal bit for bit when this build reads them back."""
    x = prof_cells.setup(n=8, device="cpu")
    calls = prof_cells.calls(x)
    assert [c[0] for c in calls] == ["prim_aux", "flatten"]
    flat = lambda o: [o] if isinstance(o, torch.Tensor) else [t for i in o for t in flat(i)]
    for name, kern, plain, comps in calls:
        got, ref = flat(kern()), flat(plain())
        assert len(got) == len(ref) > 0
        for g_, r_ in zip(got, ref):
            assert torch.equal(g_, r_), name
    lines = []
    res = prof_cells.run(x, reps=1, out=lines.append)
    assert set(res) == {"prim_aux", "flatten"} and all(v > 0 for v in res.values())
    assert all("[CPU, plain versions; not a device measurement]" in ln for ln in lines)
    ms, zps = prof_cells.time_path(8, 1, "cpu", out=lines.append)
    assert ms > 0 and zps > 0 and "CPU" in lines[-1]
    path = tmp_path / "cells.pt"
    rec = prof_cells.save(path, 8, "cpu")
    assert sorted(rec) == ["ragged, walls", "sedov 8^3"]
    assert rec["ragged, walls"]["inputs"]["u"].shape[1:] == (37, 29, 45)
    lines = []
    assert prof_cells.against(path, "cpu", out=lines.append) == 0
    assert len(lines) == 10 and all("bit for bit" in ln for ln in lines)
