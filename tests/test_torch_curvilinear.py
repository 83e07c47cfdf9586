"""Curvilinear geometry: 2D RZ and 1D spherical and cylindrical hydro of the
port against the JAX package on the CPU.

- cmpflx and trans_cmpflx with `coord` 1 and 2 (the radial momentum flux
  without the pressure): plain versions against the Pallas kernels under
  the interpreter;
- the `dloga` geometry source of the PPM and PLM traces, the area-weighted
  RZ transverse pass with `radial_p_fix`, and the RZ geometric source;
- the RZ midplane against the 1D spherical run (the JAX test's 5% L1 and
  2-cell peak bounds), and the kernel wrappers an RZ and a 1D spherical
  step call.
(tests/test_torch_curvilinear_steps.py holds the steps against the JAX
package and the restart from an RZ checkpoint.)

Tolerances as the other test_torch_* files: float64 rtol 1e-10 (plus 1e-10
of each component's largest magnitude); float32 rtol = atol = 2e-5
(tests/test_pallas.py:41); interiors only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.geometry import CoordSys as JCoord
from castro_tpu.geometry import Geometry as JGeometry
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.ops import trans as jtrans
from castro_tpu.ops.ctu import _dloga as j_dloga
from castro_tpu.ops.trace_plm import trace_plm as j_trace_plm
from castro_tpu.ops.trace_ppm import trace_ppm as j_trace_ppm
from castro_tpu.problems import sedov as jsedov
from castro_tpu.sources.geom_src import GeomSource as JGeomSource
from castro_tpu.state import StateLayout as JLayout

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.geometry import CoordSys, Geometry
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops import trans
from castro_tpu_torch.ops.ctu import _dloga
from castro_tpu_torch.ops.trace_plm import trace_plm
from castro_tpu_torch.ops.trace_ppm import trace_ppm
from castro_tpu_torch.problems import sedov
from castro_tpu_torch.sources.geom_src import GeomSource
from castro_tpu_torch.state import StateLayout

from test_torch_hydro_paths import _assert_close, _few_threads  # noqa: F401
from test_torch_kernels_unfused import _bundle, _face_states, _interpret, _t
from test_torch_plm import calls, step_calls  # noqa: F401

NG = 4
SMALL_DENS, SMALL_PRES = 1e-12, 1e-20


def _params(mod, geometry, n, dtype, stop_time=0.01, cfl=0.4):
    """Sedov in 2D RZ ("rz": r in [0, 1], z in [-1, 1], n x 2n cells), 1D
    spherical ("sph") or 1D cylindrical ("cyl1d"), the blast on the axis."""
    if geometry == "rz":
        p = mod.make_params(n=n, dim=2, coord=1, stop_time=stop_time, r_init=0.1,
                            p_ambient=1e-5, exp_energy=1.0, dtype=dtype)
        p = p.with_ns("geometry", coord_sys=1, prob_lo=(0.0, -1.0, 0.0),
                      prob_hi=(1.0, 1.0, 0.0))
        p = p.with_ns("amr", n_cell=(n, 2 * n))
        return p.with_ns("castro", lo_bc=(3, 2), hi_bc=(2, 2), cfl=cfl)
    coord = 2 if geometry == "sph" else 1
    p = mod.make_params(n=n, dim=1, coord=coord, stop_time=stop_time, r_init=0.1,
                        p_ambient=1e-5, exp_energy=1.0, dtype=dtype)
    return p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), cfl=cfl)


def _init(mod, dim):
    center = (0.0,) * dim
    return lambda s, u: mod.problem_init(s, u, center=center)


def _jax_steps(geometry, n, dtype, steps, dt, use_pallas=False):
    dim = 2 if geometry == "rz" else 1
    with jax.disable_jit():
        js = JSim(_params(jsedov, geometry, n, dtype), problem_init=_init(jsedov, dim))
        if use_pallas:
            js.cfg = js.cfg._replace(use_pallas=True)
        js.init_data()
        states = [np.asarray(js.u)]
        for k in range(steps):
            u, _, bad = js._step_impl(js.u, np.dtype(dtype).type(dt), k * dt)
            assert not bool(bad)
            js.u = u
            states.append(np.asarray(u))
    return states


def _port_steps(geometry, n, dtype, states, dt):
    dim = 2 if geometry == "rz" else 1
    sim = Simulation(_params(sedov, geometry, n, dtype), problem_init=_init(sedov, dim),
                     device="cpu")
    sim.init_data()
    inner = (slice(None),) + (slice(NG, -NG),) * dim
    if dtype == "float64":
        _assert_close(sim.interior(), states[0][inner], dtype, "init")
    u = convert.state_from_numpy(states[0], sim.layout, "cpu", sim.dtype)
    for k in range(len(states) - 1):
        u, min_rho, bad = sim._step_impl(u, dt, k * dt)
        assert not bool(bad) and float(min_rho) > 0.0
        _assert_close(sim.interior(u), states[k + 1][inner], dtype, f"step {k + 1}")
    return sim


@pytest.mark.parametrize("dim,coord", [(1, 1), (1, 2), (2, 1)],
                         ids=["1d-cylindrical", "1d-spherical", "2d-rz"])
def test_cmpflx_plain_with_coord_vs_pallas(dim, coord):
    """The radial flux carries no pressure in its momentum row; the other
    directions are unchanged."""
    JL, TL = JLayout(dim=dim, nspec=1), StateLayout(dim=dim, nspec=1)
    qm, qp, aux = _face_states(dim, seed=70 + dim + coord)
    for d in range(dim):
        ref = _interpret(pk.cmpflx_pallas, jnp.asarray(qm), jnp.asarray(qp),
                         *(jnp.asarray(a) for a in aux), d, JL, coord, 0, SMALL_DENS,
                         SMALL_PRES)
        got = K.cmpflx(_t(qm), _t(qp), *(_t(a) for a in aux), d, TL, coord, 0, SMALL_DENS,
                       SMALL_PRES)
        np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=2e-5, atol=2e-5)
        cart = K.cmpflx(_t(qm), _t(qp), *(_t(a) for a in aux), d, TL, 0, 0, SMALL_DENS,
                        SMALL_PRES)[0]
        differs = bool((cart[TL.UMX + d] != got[0][TL.UMX + d]).any())
        assert differs == (d == 0)


def test_trans_cmpflx_plain_with_coord_vs_pallas():
    JL, TL = JLayout(dim=2, nspec=1), StateLayout(dim=2, nspec=1)
    qm, qp, aux = _face_states(2, seed=80)
    bm, bp = _bundle(2, seed=81), _bundle(2, seed=82)
    # the faces whose corrected states stay sound, as in
    # test_torch_kernels_unfused.py:test_trans_cmpflx_plain_vs_pallas
    sound = np.ones(qm.shape[1:], bool)
    for q, b in ((qm, bm), (qp, bp)):
        qc = K.trans_apply_plain(*(_t(a) for a in (q, *b)), TL, SMALL_PRES, True, False).numpy()
        sound &= (qc[TL.QRHO] > 0.1 * q[TL.QRHO]) & (qc[TL.QREINT] > 0.1 * q[TL.QREINT])
    args = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux)
    ref = _interpret(pk.trans_cmpflx_pallas, *(jnp.asarray(a) for a in args), 0, JL, 1, 0,
                     SMALL_DENS, SMALL_PRES, True, False)
    got = K.trans_cmpflx(*(_t(a) for a in args), 0, TL, 1, 0, SMALL_DENS, SMALL_PRES, True,
                         False)
    ok = sound & (ref[1][TL.GDGAME] < 11.0)
    assert ok.mean() > 0.7
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_.numpy()[:, ok], r_[:, ok], rtol=2e-5, atol=2e-5)


def _prims(dim, seed):
    """Random cell primitives, aux and flattening on a grown grid (f64)."""
    rng = np.random.default_rng(seed)
    shape = (16, 24) if dim == 2 else (40,)
    L = StateLayout(dim=dim, nspec=1)
    q = np.zeros((L.NQ,) + shape)
    q[L.QRHO] = rng.uniform(0.5, 1.5, shape)
    q[L.QU:L.QW + 1] = rng.uniform(-0.5, 0.5, (3,) + shape)
    q[L.QPRES] = rng.uniform(0.3, 2.0, shape)
    q[L.QREINT] = q[L.QPRES] / 0.4
    q[L.QGAME] = 1.4
    q[L.QTEMP] = 1.0
    q[L.QFS] = 1.0
    qaux = np.zeros((L.NQAUX,) + shape)
    qaux[L.QGAMC] = 1.4
    qaux[L.QC] = np.sqrt(1.4 * q[L.QPRES] / q[L.QRHO])
    qaux[L.QDPDR] = 0.0
    qaux[L.QDPDE] = 0.4
    flatn = rng.uniform(0.5, 1.0, shape)
    src = 1e-2 * rng.standard_normal((L.NQ,) + shape)
    return q, qaux, flatn, src, shape


def _geoms(dim, coord, shape):
    kw = dict(dim=dim, prob_lo=(0.0, -1.0)[:dim], prob_hi=(1.0, 1.0)[:dim],
              n_cell=tuple(s - 2 * NG for s in shape))
    return (JGeometry(**kw, coord=JCoord(coord), dtype=jnp.float64),
            Geometry(**kw, coord=CoordSys(coord), dtype=torch.float64))


@pytest.mark.parametrize("tracer", ["ppm", "plm"])
@pytest.mark.parametrize("dim,coord", [(2, 1), (1, 2)], ids=["rz", "spherical"])
def test_trace_geometry_source_matches_jax(tracer, dim, coord):
    q, qaux, flatn, src, shape = _prims(dim, seed=90 + dim)
    jg, tg = _geoms(dim, coord, shape)
    jdl, tdl = j_dloga(jg, NG), _dloga(tg, NG)
    np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), rtol=1e-14)
    JL, TL = JLayout(dim=dim, nspec=1), StateLayout(dim=dim, nspec=1)
    dt, dx = 1e-3, tg.dx
    for d in range(dim):
        for s in (None, src):
            js = None if s is None else jnp.asarray(s)
            ts = None if s is None else torch.as_tensor(s)
            if tracer == "ppm":
                ref = j_trace_ppm(jnp.asarray(q), jnp.asarray(qaux), js, jnp.asarray(flatn), d,
                                  dt, dx[d], JL, SMALL_DENS, SMALL_PRES, dloga=jdl)
                got = trace_ppm(torch.as_tensor(q), torch.as_tensor(qaux), ts,
                                torch.as_tensor(flatn), d, dt, dx[d], TL, SMALL_DENS,
                                SMALL_PRES, dloga=tdl)
            else:
                ref = j_trace_plm(jnp.asarray(q), jnp.asarray(qaux), js, jnp.asarray(flatn), d,
                                  dt, dx[d], JL, SMALL_DENS, SMALL_PRES, dloga=jdl)
                got = trace_plm(torch.as_tensor(q), torch.as_tensor(qaux), ts,
                                torch.as_tensor(flatn), d, dt, dx[d], TL, SMALL_DENS,
                                SMALL_PRES, dloga=tdl)
            for g_, r_ in zip(got, ref):
                np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=1e-12, atol=1e-14)


def test_rz_transverse_pass_matches_jax():
    """trans_single with the RZ area weighting, radial_p_fix and
    transverse_use_eos, both normal directions."""
    from castro_tpu.eos.gamma_law import GammaLawEos as JEos
    from castro_tpu.network.general_null import GeneralNullNetwork as JNull
    from castro_tpu_torch.eos.gamma_law import GammaLawEos
    from castro_tpu_torch.network import GeneralNullNetwork

    q, qaux, flatn, _, shape = _prims(2, seed=95)
    jg, tg = _geoms(2, 1, shape)
    JL, TL = JLayout(dim=2, nspec=1), StateLayout(dim=2, nspec=1)
    rng = np.random.default_rng(96)
    qm, qp = (q * rng.uniform(0.9, 1.1, q.shape) for _ in range(2))
    flux = 0.05 * rng.standard_normal((TL.NVAR,) + shape)
    qe = np.abs(rng.uniform(0.2, 1.0, (TL.NGDNV,) + shape))
    hdt = 5e-4
    for eos in (None, "eos"):
        jeos = JEos(1.4, network=JNull()) if eos else None
        teos = GammaLawEos(1.4, network=GeneralNullNetwork()) if eos else None
        for n, t in ((0, 1), (1, 0)):
            jgt = {"area": jg.face_area(t, NG), "vol": jg.volume(NG)}
            tgt = {"area": tg.face_area(t, NG), "vol": tg.volume(NG)}
            fix = t == 0
            ref = jtrans.trans_single(jnp.asarray(qm), jnp.asarray(qp), jnp.asarray(flux),
                                      jnp.asarray(qe), jnp.asarray(qaux), n, t,
                                      hdt / tg.dx[t], JL, SMALL_PRES, True, False,
                                      geom_terms=jgt, radial_p_fix=fix, hdt=hdt, use_eos=jeos)
            got = trans.trans_single(*(torch.as_tensor(a) for a in (qm, qp, flux, qe, qaux)),
                                     n, t, hdt / tg.dx[t], TL, SMALL_PRES, True, False,
                                     geom_terms=tgt, radial_p_fix=fix, hdt=hdt,
                                     use_kernels=True, use_eos=teos)
            for g_, r_ in zip(got, ref):
                np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=1e-12, atol=1e-14)
    assert K.trans_apply.launches == 0  # the RZ pass stays torch ops


def test_geom_source_matches_jax():
    _, _, _, _, shape = _prims(2, seed=97)
    jg, tg = _geoms(2, 1, shape)
    JL, TL = JLayout(dim=2, nspec=1), StateLayout(dim=2, nspec=1)
    rng = np.random.default_rng(98)
    u = rng.uniform(0.5, 1.5, (TL.NVAR,) + shape)
    u[TL.UMX:TL.UMZ + 1] -= 1.0
    ref = JGeomSource(None, jg, JL, NG)(None, jnp.asarray(u), None, None, 0.0, 1e-3)
    got = GeomSource(None, tg, TL, NG)(None, torch.as_tensor(u), None, None, 0.0, 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


def test_rz_midplane_matches_1d_spherical():
    """The setup and bounds of tests/test_sedov_analytic.py: relative L1 of the RZ midplane density against the 1D spherical run
    under 5%, peaks within 2 cells, the RZ run mirror-symmetric in z."""
    n = 64
    s1 = Simulation(_params(sedov, "sph", n, "float64"), problem_init=_init(sedov, 1),
                    device="cpu").run(verbose=False)
    s2 = Simulation(_params(sedov, "rz", n, "float64"), problem_init=_init(sedov, 2),
                    device="cpu").run(verbose=False)
    rho1 = s1.interior()[0].numpy()
    u2 = s2.interior().numpy()
    rho2 = 0.5 * (u2[0][:, n - 1] + u2[0][:, n])
    assert np.abs(rho2 - rho1).mean() / rho1.mean() < 0.05
    assert abs(int(np.argmax(rho2)) - int(np.argmax(rho1))) <= 2
    np.testing.assert_allclose(u2[0], u2[0][:, ::-1], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("geometry,expected", [("rz", {"cmpflx": 4}), ("sph", {"cmpflx": 1})])
def test_kernel_structure(calls, geometry, expected):
    """An RZ step solves its four Riemann problems on cmpflx (the wall face
    on the axis included) and leaves the rest to torch ops; a 1D spherical
    step calls cmpflx once."""
    dim = 2 if geometry == "rz" else 1
    sim = Simulation(_params(sedov, geometry, 8, "float32"), problem_init=_init(sedov, dim),
                     device="cpu")
    assert step_calls(sim, calls) == expected
