"""The characteristic rad-CTU chain of the port (`ops/rad_hydro.py`, the
radiation branch of `ctoprim`, the radiation terms of `ops/trans.py`)
against the JAX package's on the same seeded inputs, in 1D, 1D spherical,
2D and 2D RZ, gray and multigroup (3D in tests/test_torch_rad_steps_3d.py);
and the plain versions of cmpflx and trans_cmpflx on the radiation layout
against the JAX Pallas kernels in interpret mode.

Each case builds both packages' Simulation from the same parameters (for
their geometry, layout and HydroConfig), a random grown state with Er and
flux limiters, and compares: ctoprim with and without Er (the operator-
split step's zeros), trace_ppm_rad in each direction (with a source and
the curvilinear dloga), riemannus_rad + rad_flux_and_qe, rad_flatten,
apply_av_rad, ctu_rad_consup, and ctu_rad_hydro whole (interiors only).

Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per leading component
(tests/test_torch_radiation.py:close); the Pallas comparisons float32
rtol = atol = 2e-5 (tests/test_pallas.py:41's budget).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.ops import advection_util as jau
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.ops import rad_hydro as jrh

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops import rad_hydro as trh

from test_torch_radiation import _few_threads, close, t64  # noqa: F401

CASES = {"1d": (1, 0, 1), "1d-sph": (1, 2, 1), "2d": (2, 0, 1), "2d-rz": (2, 1, 1),
         "2d-4groups": (2, 0, 4)}
N = {1: 24, 2: 12, 3: 6}


def _params(P, dim, coord, ngroups, comoving=1):
    n = N[dim]
    p = P().with_ns("amr", n_cell=(n,) * dim)
    lo = (0.2, 0.0, 0.0) if coord else (0.0,) * 3
    p = p.with_ns("geometry", prob_lo=lo, prob_hi=(1.2,) * 3, coord_sys=coord)
    p = p.with_ns("castro", do_radiation=1, lo_bc=(2,) * dim, hi_bc=(2,) * dim,
                  small_dens=1e-12, small_pres=1e-15)
    mg = dict(lowest_group_hz=1e13, highest_group_hz=1e17) if ngroups > 1 else {}
    p = p.with_ns("radiation", ngroups=ngroups, limiter=2, comoving=comoving,
                  flatten_pp_threshold=0.5, const_kappa_r=10.0, **mg)
    return p.with_ns("eos", eos_gamma=5.0 / 3.0).with_ns("tpu", dtype="float64")


def _inputs(dim, coord, ngroups, comoving=1):
    js = JSim(_params(JParams, dim, coord, ngroups, comoving))
    ts = Simulation(_params(Params, dim, coord, ngroups, comoving), device="cpu")
    L = ts.layout
    g = ts.grown_shape()
    rng = np.random.default_rng(dim * 10 + coord + ngroups)
    rho = rng.uniform(0.5, 1.5, g)
    vel = rng.uniform(-0.3, 0.3, (3,) + g)
    rhoe = rng.uniform(0.5, 2.0, g)
    u = np.zeros((L.NVAR,) + g)
    u[L.URHO] = rho
    u[L.UMX:L.UMZ + 1] = rho * vel
    u[L.UEINT] = rhoe
    u[L.UEDEN] = rhoe + 0.5 * rho * (vel ** 2).sum(0)
    u[L.UTEMP] = 1.0
    u[L.UFS] = rho
    Er = rng.uniform(0.1, 1.0, (ngroups,) + g)
    lam = rng.uniform(0.05, 1.0 / 3.0, (ngroups,) + g)
    src = 1e-2 * rng.standard_normal((L.NVAR,) + g)
    return js, ts, u, Er, lam, src


def _int(a, ng, dim, lead=1):
    return np.asarray(a)[(slice(None),) * lead + (slice(ng, -ng),) * dim]


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_rad_ctu_chain(case):
    check_chain(*CASES[case])


def check_chain(dim, coord, ngroups):
    """Every piece of the chain, then the chain whole (the 3D case in
    tests/test_torch_rad_steps_3d.py)."""
    js, ts, u, Er, lam, src = _inputs(dim, coord, ngroups)
    L, ng = ts.layout, ts.ng
    args = (ts.cfg.small_dens, ts.small_temp)
    # ctoprim: with Er the radiation branch; without, the operator-split
    # step's zeros in the radiation slots
    tq, tqa = au.ctoprim(t64(u), L, ts.eos, *args, Er=t64(Er), lam=t64(lam), rad_limiter=2)
    jq, jqa = jau.ctoprim(jnp.asarray(u), js.layout, js.eos, *args, Er=jnp.asarray(Er),
                          lam=jnp.asarray(lam), rad_limiter=2)
    close(tq, jq, what="q")
    close(tqa, jqa, what="qaux")
    q0, qa0 = au.ctoprim(t64(u), L, ts.eos, *args)
    jq0, jqa0 = jau.ctoprim(jnp.asarray(u), js.layout, js.eos, *args)
    close(q0, jq0, what="q, no Er")
    close(qa0, jqa0, what="qaux, no Er")
    assert float(q0[L.QPTOT:L.QFS].abs().max()) == 0.0

    tsrc = au.src_to_prim(tq, tqa, t64(src), L)
    jsrc = jau.src_to_prim(jq, jqa, jnp.asarray(src), js.layout)
    close(tsrc, jsrc, what="srcQ")
    tfl = trh.rad_flatten(tq, L, 0.5)
    jfl = jrh.rad_flatten(jq, js.layout, 0.5)
    close(tfl, jfl, what="flatn")
    from castro_tpu.ops.ctu import _dloga as jdloga
    from castro_tpu_torch.ops.ctu import _dloga

    dt = 1e-3
    for d in range(dim):
        dl, jdl = (_dloga(ts.geom, ng), jdloga(js.geom, ng)) if d == 0 else (None, None)
        for s_t, s_j in ((tsrc, jsrc), (None, None)):
            got = trh.trace_ppm_rad(tq, tqa, s_t, tfl, d, dt, ts.geom.dx[d], L, 1e-12, 1e-15,
                                    dloga=dl)
            ref = jrh.trace_ppm_rad(jq, jqa, s_j, jfl, d, dt, js.geom.dx[d], js.layout, 1e-12,
                                    1e-15, dloga=jdl)
            for a, b, nm in zip(got, ref, ("qm", "qp")):
                close(_int(a, 2, dim), _int(b, 2, dim), what=f"{nm} d={d}")
        gd = trh.riemannus_rad(got[0], got[1], tqa, d, L, 1e-12, 1e-15)
        jgd = jrh.riemannus_rad(ref[0], ref[1], jqa, d, js.layout, 1e-12, 1e-15)
        out = trh.rad_flux_and_qe(gd, got[0], got[1], d, L, ts.geom.coord, 2, 3)
        jout = jrh.rad_flux_and_qe(jgd, ref[0], ref[1], d, js.layout, js.geom.coord, 2, 3)
        for a, b, nm in zip(out, jout, ("flux", "rflux", "qe")):
            close(_int(a, 3, dim), _int(b, 3, dim), what=f"{nm} d={d}")
        div = au.divu_node(tq, ts.geom.dx, L)
        close(_int(trh.apply_av_rad(out[1], d, div, tq[L.QRAD:L.QRAD + ngroups], L, 0.1,
                                    ts.geom.dx), 3, dim),
              _int(jrh.apply_av_rad(jout[1], d, jau.divu_node(jq, js.geom.dx, js.layout),
                                    jq[js.layout.QRAD:js.layout.QRAD + ngroups], js.layout, 0.1,
                                    js.geom.dx), 3, dim), what=f"av d={d}")

    # the whole chain: u_new and the interior Er (the consup's work terms,
    # f-space advection with 4 groups)
    Er_int = Er[(slice(None),) + (slice(ng, -ng),) * dim]
    rp = ts.params.radiation
    kw = dict(nugroup=ts.rad.nugroup, dlognu=ts.rad.dlognu, fspace_type=1, comoving=1,
              flatten_pp_threshold=0.5)
    got = trh.ctu_rad_hydro(t64(u), t64(Er_int), tq, tqa, tsrc, dt, ts.geom, L, ts.cfg, 2,
                            rp.closure, keep_fluxes=True, **kw)
    ref = jrh.ctu_rad_hydro(jnp.asarray(u), jnp.asarray(Er_int), jq, jqa, jsrc, dt, js.geom,
                            js.layout, js.cfg, 2, rp.closure,
                            **dict(kw, nugroup=js.rad.nugroup, dlognu=js.rad.dlognu),
                            keep_fluxes=True)
    close(_int(got[0], ng, dim), _int(ref[0], ng, dim), what="u_new")
    close(got[1], ref[1], what="Er_new")
    for d in range(dim):
        close(_int(got[2][d], ng, dim), _int(ref[2][d], ng, dim), what=f"gas flux {d}")
        close(_int(got[3][d], ng, dim), _int(ref[3][d], ng, dim), what=f"rad flux {d}")


def test_rad_ctu_mixed_frame():
    """comoving = 0 (Rad2Tshock's mixed frame): the consup's kinetic-energy
    exchange goes to the lab-frame Er."""
    js, ts, u, Er, lam, src = _inputs(2, 0, 1, comoving=0)
    L, ng = ts.layout, ts.ng
    args = (ts.cfg.small_dens, ts.small_temp)
    tq, tqa = au.ctoprim(t64(u), L, ts.eos, *args, Er=t64(Er), lam=t64(lam))
    jq, jqa = jau.ctoprim(jnp.asarray(u), js.layout, js.eos, *args, Er=jnp.asarray(Er),
                          lam=jnp.asarray(lam))
    Er_int = Er[(slice(None),) + (slice(ng, -ng),) * 2]
    got = trh.ctu_rad_hydro(t64(u), t64(Er_int), tq, tqa, None, 1e-3, ts.geom, L, ts.cfg, 2, 3,
                            comoving=0)
    ref = jrh.ctu_rad_hydro(jnp.asarray(u), jnp.asarray(Er_int), jq, jqa, None, 1e-3, js.geom,
                            js.layout, js.cfg, 2, 3, comoving=0)
    close(_int(got[0], ng, 2), _int(ref[0], ng, 2), what="u_new")
    close(got[1], ref[1], what="Er_new")


def _interpret(fn, *a, **kw):
    pk.INTERPRET = True
    try:
        return jax.tree_util.tree_map(np.asarray, fn(*a, **kw))
    finally:
        pk.INTERPRET = False


@pytest.mark.parametrize("ngroups", [1, 4], ids=["gray", "4groups"])
def test_cmpflx_plain_radiation_layout_vs_pallas(ngroups):
    """The operator-split step's solves on the radiation layout: the plain
    versions against the JAX Pallas kernels (interpret mode), float32."""
    from castro_tpu.state import StateLayout as JLayout
    from castro_tpu_torch.ops.trans import term_bundle
    from castro_tpu_torch.state import StateLayout

    shape = (16, 12)
    JL = JLayout(dim=2, nspec=2, radiation=True, ngroups=ngroups)
    TL = StateLayout(dim=2, nspec=2, radiation=True, ngroups=ngroups)
    rng = np.random.default_rng(ngroups)

    def state():
        q = np.zeros((TL.NQ,) + shape)
        q[TL.QRHO] = rng.uniform(0.5, 1.5, shape)
        q[TL.QU:TL.QW + 1] = rng.uniform(-0.5, 0.5, (3,) + shape)
        q[TL.QPRES] = rng.uniform(0.5, 2.0, shape)
        q[TL.QREINT] = q[TL.QPRES] / 0.4
        q[TL.QGAME] = 1.4
        q[TL.QTEMP] = 1.0
        q[TL.QPTOT:TL.QFS] = rng.uniform(0.1, 1.0, (TL.QFS - TL.QPTOT,) + shape)
        q[TL.QFS:TL.QFS + 2] = rng.dirichlet((1.0, 1.0), shape).transpose(2, 0, 1)
        return q.astype(np.float32)

    qm, qp = state(), state()
    aux = [rng.uniform(lo, hi, shape).astype(np.float32)
           for lo, hi in ((1.3, 1.7), (1.3, 1.7), (0.5, 1.5), (0.5, 1.5))]
    for d in range(2):
        ref = _interpret(pk.cmpflx_pallas, jnp.asarray(qm), jnp.asarray(qp),
                         *(jnp.asarray(a) for a in aux), d, JL, 0, 0, 1e-12, 1e-20)
        got = K.cmpflx(*(torch.as_tensor(a) for a in (qm, qp, *aux)), d, TL, 0, 0, 1e-12, 1e-20)
        for g_, r_ in zip(got, ref):
            np.testing.assert_allclose(g_.numpy(), r_, rtol=2e-5, atol=2e-5)
        assert float(got[1][6:].abs().max()) == 0.0
    # the final stage: both states corrected by a mild bundle, then solved
    fl = K.cmpflx(*(torch.as_tensor(a) for a in (qm, qp, *aux)), 1, TL, 0, 0, 1e-12, 1e-20)
    qaux = torch.stack([torch.as_tensor(a) for a in (aux[1], aux[3])] +
                       [torch.ones(shape)] * (TL.NQAUX - 2))
    term = [{"flux": fl[0], "qe": fl[1], "t_dir": 1, "cdtdx": 0.05}]
    bp = term_bundle(term, qaux, 0, 0, TL)
    bm = term_bundle(term, qaux, 0, -1, TL)
    targs = [qm, qp, bm[0].numpy(), bp[0].numpy(), bm[1].numpy(), bp[1].numpy(), bm[2].numpy(),
             bp[2].numpy(), *aux]
    ref = _interpret(pk.trans_cmpflx_pallas, *(jnp.asarray(a) for a in targs), 0, JL, 0, 0,
                     1e-12, 1e-20, True, False)
    got = K.trans_cmpflx(*(torch.as_tensor(np.asarray(a)) for a in targs), 0, TL, 0, 0, 1e-12,
                         1e-20, True, False)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_.numpy(), r_, rtol=2e-5, atol=2e-5)
