"""The MHD modules of the port (`castro_tpu_torch/mhd/`, `ops/fill.py:
fill_face`, the face operators of `ops/interlevel.py`) against the JAX
package's on the same inputs, made from a numpy seed: the HLLD solver and
the fast speed (with Bn = 0 and star states whose denominator vanishes), the
eigensystem (with a vanishing transverse field and cf = cs), the extended
state conversions and HLLD, the edge EMFs, the half-time primitives, the
PLM and PPM interface states, the face fill in the four cases of
tests/test_fill_face.py, and the divergence-free face prolongation and edge
restriction.

Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per leading component
(`tests/test_torch_radiation.py:close`), float32 rtol = atol = 2e-5;
exact where the operation is a copy or a gather (the fills, the face
operators).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.mhd import ctu_ct as jcc
from castro_tpu.ops import fill as jfill
from castro_tpu.ops import interlevel as jil

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.mhd import ctu_ct as tcc
from castro_tpu_torch.ops import fill as tfill
from castro_tpu_torch.ops import interlevel as til

from test_torch_radiation import _few_threads, close  # noqa: F401

jax.config.update("jax_enable_x64", True)
# the modules themselves (each package's mhd/__init__.py exports a function
# of the same name)
jhlld = importlib.import_module("castro_tpu.mhd.hlld")
thlld = importlib.import_module("castro_tpu_torch.mhd.hlld")

DTYPES = pytest.mark.parametrize("dtype", ["float64", "float32"])
TDT = {"float64": torch.float64, "float32": torch.float32}


def _sims(dim=3, n=8, dtype="float64", gamma=5.0 / 3.0):
    """Both packages' MHD Simulations on a periodic box (their layouts and
    EOSes)."""
    out = []
    for P, S, kw in ((JParams, JSim, {}), (Params, Simulation, dict(device="cpu"))):
        p = P().with_ns("amr", n_cell=(n,) * dim)
        p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
        p = p.with_ns("castro", do_mhd=1, lo_bc=(0,) * dim, hi_bc=(0,) * dim)
        p = p.with_ns("eos", eos_gamma=gamma).with_ns("tpu", dtype=dtype)
        out.append(S(p, **kw))
    return out


def _face_states(rng, shape, degenerate=False):
    """Two random MHD face states (rho, un, ut1, ut2, p, Bt1, Bt2) and Bn:
    Bn = 0 on a quarter of the faces; with `degenerate`, star states whose
    denominator rho (S - u)(S - S_M) - Bn^2 vanishes (a vanishing
    transverse field and equal states)."""
    def side():
        return dict(rho=rng.uniform(0.3, 2.0, shape), un=rng.uniform(-1, 1, shape),
                    ut1=rng.uniform(-1, 1, shape), ut2=rng.uniform(-1, 1, shape),
                    p=rng.uniform(0.1, 2.0, shape), Bt1=rng.uniform(-1, 1, shape),
                    Bt2=rng.uniform(-1, 1, shape))
    L, R = side(), side()
    Bn = rng.uniform(-1.5, 1.5, shape)
    Bn[rng.random(shape) < 0.25] = 0.0
    if degenerate:
        k = rng.random(shape) < 0.5
        for key in L:
            R[key] = np.where(k, L[key], R[key])
        for s_ in (L, R):
            s_["Bt1"] = np.where(k, 0.0, s_["Bt1"])
            s_["Bt2"] = np.where(k, 0.0, s_["Bt2"])
    return L, R, Bn


def _states(mod, arrays, gamma, as_t):
    return mod.MhdFaceState(e=as_t(arrays["p"] / (arrays["rho"] * (gamma - 1.0))),
                            **{k: as_t(v) for k, v in arrays.items()})


@DTYPES
@pytest.mark.parametrize("degenerate", [False, True], ids=["random", "degenerate"])
def test_hlld_and_fast_speed(dtype, degenerate):
    rng = np.random.default_rng(1 + degenerate)
    shape = (64, 48)
    gamma = 5.0 / 3.0
    L, R, Bn = _face_states(rng, shape, degenerate)
    npdt = np.dtype(dtype)

    def jt(a):
        return jnp.asarray(np.asarray(a, npdt))

    def tt(a):
        return torch.as_tensor(np.asarray(a, npdt))

    Fj, SMj = jhlld.hlld(_states(jhlld, L, gamma, jt), _states(jhlld, R, gamma, jt), jt(Bn), gamma)
    Ft, SMt = thlld.hlld(_states(thlld, L, gamma, tt), _states(thlld, R, gamma, tt), tt(Bn), gamma)
    Fj = np.asarray(Fj)
    # equal states with Bt = 0 and an Alfven speed above the sound speed:
    # some faces' star-state denominator rounds to a value the guard passes
    # and both packages give NaN there, at the same faces
    bad_t = ~torch.isfinite(Ft).all(0).numpy()
    np.testing.assert_array_equal(bad_t, ~np.isfinite(Fj).all(0))
    if not degenerate:
        assert not bad_t.any()
    close(Ft[:, ~bad_t], Fj[:, ~bad_t], dtype, "hlld flux")
    close(SMt[None], np.asarray(SMj)[None], dtype, "hlld S_M")
    cfj = jhlld.fast_speed(jt(L["rho"]), jt(L["p"]), jt(Bn), jt(L["Bt1"]), jt(L["Bt2"]), gamma)
    cft = thlld.fast_speed(tt(L["rho"]), tt(L["p"]), tt(Bn), tt(L["Bt1"]), tt(L["Bt2"]), gamma)
    close(cft[None], np.asarray(cfj)[None], dtype, "fast speed")


@DTYPES
def test_mhd_eigensystem(dtype):
    """mhd_evals and mhd_evecs on random states, with a vanishing
    transverse field (bet = 1/sqrt 2) and cf = cs (the degenerate alpha
    branch: Bn^2/rho = a^2, Bt = 0, at values whose discriminant is 0
    exactly; where it is 0 only to round-off, its square root carries 1e-8
    of either package's rounding) on some of them."""
    rng = np.random.default_rng(3)
    shape = (40, 30)
    npdt = np.dtype(dtype)
    rho = rng.uniform(0.3, 2.0, shape)
    as2 = rng.uniform(0.1, 2.0, shape)
    un = rng.uniform(-1, 1, shape)
    Bn = rng.uniform(-1.5, 1.5, shape)
    Bt1 = rng.uniform(-1, 1, shape)
    Bt2 = rng.uniform(-1, 1, shape)
    Bn[:, :5] = 0.0
    Bt1[:8], Bt2[:8] = 0.0, 0.0
    # Bt = 0 (rows :8) at powers of two, so that the discriminant
    # (a^2 + Bn^2/rho)^2 - 4 a^2 Bn^2/rho = (a^2 - Bn^2/rho)^2 and its root
    # are exact; cf = cs on rows :4 (a^2 = Bn^2/rho)
    pick = rng.integers(0, 3, (8,) + shape[1:])
    rho[:8] = np.asarray([0.25, 1.0, 4.0])[pick]
    as2[:8] = np.asarray([4.0, 0.25, 1.0])[pick]
    Bn[:8] = np.where(rng.random((8,) + shape[1:]) < 0.5, -1.0, 1.0) * np.asarray(
        [0.5, 1.0, 2.0])[pick]
    as2[:4] = Bn[:4] ** 2 / rho[:4]
    args = (as2, rho, Bn, Bt1, Bt2)
    jl, jr = jcc.mhd_evecs(*(jnp.asarray(np.asarray(a, npdt)) for a in args))
    tl, tr = tcc.mhd_evecs(*(torch.as_tensor(np.asarray(a, npdt)) for a in args))
    close(torch.stack([torch.stack(r) for r in tl]),
          np.stack([np.stack([np.asarray(x) for x in r]) for r in jl]), dtype, "left eigenvectors")
    close(torch.stack([torch.stack(r) for r in tr]),
          np.stack([np.stack([np.asarray(x) for x in r]) for r in jr]), dtype,
          "right eigenvectors")
    ev_args = (as2, un, rho, Bn, Bt1, Bt2)
    je = jcc.mhd_evals(*(jnp.asarray(np.asarray(a, npdt)) for a in ev_args))
    te = tcc.mhd_evals(*(torch.as_tensor(np.asarray(a, npdt)) for a in ev_args))
    close(torch.stack(te), np.stack([np.asarray(x) for x in je]), dtype, "eigenvalues")


def _ext_prim(rng, L, shape):
    """A random extended primitive state [NQ+3, shape] (positive rho, p)."""
    q = np.zeros((L.NQ + 3,) + shape)
    q[L.QRHO] = rng.uniform(0.3, 2.0, shape)
    q[L.QU:L.QW + 1] = rng.uniform(-1, 1, (3,) + shape)
    q[L.QPRES] = rng.uniform(0.1, 2.0, shape)
    q[L.QFS] = 1.0
    q[L.NQ:L.NQ + 3] = rng.uniform(-1, 1, (3,) + shape)
    return q


@DTYPES
def test_extended_conversions_and_hlld_ext(dtype):
    """prim_to_cons_ext, cons_to_prim_ext (a random conserved state, a
    floored internal energy where the magnetic energy exceeds it) and
    hlld_ext in each direction."""
    js, ts = _sims(dtype=dtype)
    L = ts.layout
    rng = np.random.default_rng(5)
    shape = (6, 5, 4)
    npdt = np.dtype(dtype)
    ql = np.asarray(_ext_prim(rng, L, shape), npdt)
    qr = np.asarray(_ext_prim(rng, L, shape), npdt)
    uj = jcc.prim_to_cons_ext(jnp.asarray(ql), js.layout, js.eos)
    ut = tcc.prim_to_cons_ext(torch.as_tensor(ql), L, ts.eos)
    close(ut, np.asarray(uj), dtype, "prim_to_cons_ext")
    ux = np.asarray(uj, np.float64).copy()
    ux[L.UEDEN, :2] *= 0.1  # rho e < 0 before the floor
    ux = np.asarray(ux, npdt)
    close(tcc.cons_to_prim_ext(torch.as_tensor(ux), L, ts.eos, 1e-12),
          np.asarray(jcc.cons_to_prim_ext(jnp.asarray(ux), js.layout, js.eos, 1e-12)), dtype,
          "cons_to_prim_ext")
    for d in range(3):
        fj = jcc.hlld_ext(jnp.asarray(ql), jnp.asarray(qr), d, js.layout, js.eos, 1e-12, 1e-15)
        ft = tcc.hlld_ext(torch.as_tensor(ql), torch.as_tensor(qr), d, L, ts.eos, 1e-12, 1e-15)
        close(ft, np.asarray(fj), dtype, f"hlld_ext d={d}")


def test_interface_states_edge_emfs_and_half_time_prims():
    """The PLM interface states (characteristic and primitive limiting)
    and the PPM ones in each direction with a source term, the edge EMFs of
    the first round, corner coupling, the half step and the half-time
    primitives, on a smooth random 3D state with its face B."""
    js, ts = _sims(n=6)
    L = ts.layout
    rng = np.random.default_rng(7)
    shape = ts.grown_shape()
    x = np.meshgrid(*(np.linspace(0, 2 * np.pi, s_) for s_ in shape), indexing="ij")
    wave = np.sin(x[0] + 2 * x[1] + 0.5) * np.cos(x[2] - 0.3)
    u = np.zeros((L.NVAR,) + shape)
    u[L.URHO] = 1.0 + 0.3 * wave
    u[L.UMX:L.UMZ + 1] = rng.uniform(-0.2, 0.2, (3, 1, 1, 1)) * u[L.URHO]
    u[L.UEINT] = 1.5 + 0.2 * wave
    u[L.UFS] = u[L.URHO]
    b = tuple(0.5 + 0.2 * np.roll(wave, k, axis=k) for k in range(3))
    uj, bj = jnp.asarray(u), tuple(jnp.asarray(bb) for bb in b)
    ut, bt = torch.as_tensor(u), tuple(torch.as_tensor(bb) for bb in b)
    qj, csj = js.mhd.ctoprim_ext(uj, bj)
    qt, cst = ts.mhd.ctoprim_ext(ut, bt)
    close(qt, np.asarray(qj), what="ctoprim_ext")
    flat = np.ones(shape)
    srcq = 0.01 * rng.standard_normal((L.NQ + 3,) + shape)
    dt, dx = 0.01, ts.geom.dx
    emf = {}
    for d in range(3):
        for name, call in (("plm char", lambda m, *a: m.plm_mhd(*a, limit_characteristic=True)),
                           ("plm prim", lambda m, *a: m.plm_mhd(*a, limit_characteristic=False)),
                           ("ppm", lambda m, *a: m.ppm_mhd(*a))):
            mj = call(jcc, qj, csj, jnp.asarray(srcq), jnp.asarray(flat), bj, d, dt, dx[d],
                      js.layout, js.eos, 1e-12, 1e-15)
            mt = call(tcc, qt, cst, torch.as_tensor(srcq), torch.as_tensor(flat), bt, d, dt, dx[d],
                      L, ts.eos, 1e-12, 1e-15)
            for k_, (a, r) in enumerate(zip(mt, mj)):
                close(a, np.asarray(r), what=f"{name} d={d} {'qm' if k_ == 0 else 'qp'}")
        emf[d] = (mt, mj)
    fl = {d: (tcc.hlld_ext(*emf[d][0], d, L, ts.eos, 1e-12, 1e-15),
              jcc.hlld_ext(*emf[d][1], d, js.layout, js.eos, 1e-12, 1e-15)) for d in range(3)}
    E = {}
    for k in range(3):
        E[k] = (tcc.electric_edge(k, qt, fl[(k + 1) % 3][0], fl[(k + 2) % 3][0], L),
                jcc.electric_edge(k, qj, fl[(k + 1) % 3][1], fl[(k + 2) % 3][1], js.layout))
        close(E[k][0][None], np.asarray(E[k][1])[None], what=f"electric_edge k={k}")
    ur = {d: (tcc.prim_to_cons_ext(emf[d][0][1], L, ts.eos),
              jcc.prim_to_cons_ext(emf[d][1][1], js.layout, js.eos)) for d in range(3)}
    ul = {d: (tcc.prim_to_cons_ext(emf[d][0][0], L, ts.eos),
              jcc.prim_to_cons_ext(emf[d][1][0], js.layout, js.eos)) for d in range(3)}
    d1, d2, d3 = 0, 1, 2
    cc_t = tcc.corner_couple(ur[d1][0], ul[d1][0], fl[d2][0], E[d1][0], E[d3][0], d1, d2, d3,
                             dt, dx, L, ts.eos, 1e-12)
    cc_j = jcc.corner_couple(ur[d1][1], ul[d1][1], fl[d2][1], E[d1][1], E[d3][1], d1, d2, d3,
                             dt, dx, js.layout, js.eos, 1e-12)
    hs_t = tcc.half_step(ur[0][0], ul[0][0], fl[1][0], fl[2][0], E[0][0], E[1][0], E[2][0],
                         0, 1, 2, dt, dx, L, ts.eos, 1e-12)
    hs_j = jcc.half_step(ur[0][1], ul[0][1], fl[1][1], fl[2][1], E[0][1], E[1][1], E[2][1],
                         0, 1, 2, dt, dx, js.layout, js.eos, 1e-12)
    for name, (a2, r2) in (("corner_couple", (cc_t, cc_j)), ("half_step", (hs_t, hs_j))):
        for a, r in zip(a2, r2):
            close(a, np.asarray(r), what=name)
    close(tcc.prim_half(qt, [fl[d][0] for d in range(3)], dt, dx, L, ts.eos),
          np.asarray(jcc.prim_half(qj, [fl[d][1] for d in range(3)], dt, dx, js.layout, js.eos)),
          what="prim_half")


def test_transverse_2d():
    js, ts = _sims(dim=2, n=8)
    L = ts.layout
    rng = np.random.default_rng(9)
    shape = ts.grown_shape()
    q = [_ext_prim(rng, L, shape) for _ in range(2)]
    ur = [jcc.prim_to_cons_ext(jnp.asarray(a), js.layout, js.eos) for a in q]
    flx = jcc.hlld_ext(jnp.asarray(q[0]), jnp.asarray(q[1]), 1, js.layout, js.eos, 1e-12, 1e-15)
    Ez = jnp.asarray(rng.uniform(-1, 1, shape))
    out_j = jcc.transverse_2d(ur[0], ur[1], flx, Ez, 0, 1, 0.01, js.geom.dx, js.layout, js.eos,
                              1e-12)
    out_t = tcc.transverse_2d(*(torch.as_tensor(np.array(a)) for a in (ur[0], ur[1], flx, Ez)),
                              0, 1, 0.01, ts.geom.dx, L, ts.eos, 1e-12)
    for a, r in zip(out_t, out_j):
        close(a, np.asarray(r), what="transverse_2d")


def _grown(n, ng, dim):
    """A face field with distinct interior values (tests/test_fill_face.py)."""
    shape = tuple(n + 2 * ng for _ in range(dim))
    b = np.zeros(shape)
    rng = np.random.default_rng(0)
    b[tuple(slice(ng, ng + n) for _ in range(dim))] = rng.normal(size=(n,) * dim)
    return b


@pytest.mark.parametrize("case", ["periodic", "wall", "transverse", "outflow"])
def test_fill_face(case):
    """fill_face equal to the JAX package's, with tests/test_fill_face.py's
    checks on the port's result."""
    n, ng = 8, 2
    dim = 1 if case == "outflow" else 2
    b = _grown(n, ng, dim)
    bcs = {"periodic": [((0, 0), (0, 0))], "wall": [((3, 0), (3, 0))],
           "transverse": [((0, 4), (0, 4)), ((0, 5), (0, 5))], "outflow": [((2,), (2,))]}[case]
    outs = []
    for lo, hi in bcs:
        ref = np.asarray(jfill.fill_face(jnp.asarray(b), 0, dim, ng, lo, hi))
        got = tfill.fill_face(torch.as_tensor(b), 0, dim, ng, lo, hi).numpy()
        np.testing.assert_array_equal(got, ref)
        outs.append(got)
    out = outs[0]
    if case == "periodic":
        assert np.allclose(out[ng - 1, ng:ng + n], out[ng - 1 + n, ng:ng + n])
        assert np.allclose(out[ng:ng + n, ng - 1], out[ng:ng + n, ng + n - 1])
    elif case == "wall":
        assert np.allclose(out[ng - 1, ng:ng + n], -out[ng + 1, ng:ng + n])
        assert np.allclose(out[ng - 2, ng:ng + n], -out[ng + 2, ng:ng + n])
        assert np.allclose(out[ng + n], 0.0)
        assert np.allclose(out[ng + n + 1, ng:ng + n], -out[ng + n - 1, ng:ng + n])
    elif case == "transverse":
        assert np.allclose(out[ng:ng + n, ng - 1], out[ng:ng + n, ng])
        assert np.allclose(outs[1][ng:ng + n, ng - 1], -outs[1][ng:ng + n, ng])
    else:
        assert np.allclose(out[:ng], out[ng])
        assert np.allclose(out[ng + n:], out[ng + n - 1])


@pytest.mark.parametrize("dim", [2, 3])
def test_prolong_face_and_restrict_edge(dim):
    """prolong_face keeps a discretely divergence-free field divergence-free
    on the fine grid and equals the JAX package's; restrict_edge and
    restrict_face equal the JAX package's."""
    rng = np.random.default_rng(11 + dim)
    n = 6
    # a divergence-free coarse field: the discrete curl of a random edge
    # potential A (faces 0..n along the normal, cells 0..n-1 across)
    def dp(a, ax):  # a[i+1] - a[i] along ax, cropped to n+1 entries a side
        return np.diff(a, axis=ax)[tuple(slice(0, n + 1) for _ in range(a.ndim))]

    if dim == 2:
        A = rng.standard_normal((n + 2, n + 2))
        full = [dp(A, 1), -dp(A, 0)]
    else:
        A = [rng.standard_normal((n + 2,) * 3) for _ in range(3)]
        full = [dp(A[2], 1) - dp(A[1], 2), dp(A[0], 2) - dp(A[2], 0),
                dp(A[1], 0) - dp(A[0], 1)]
    bc = []
    for d in range(dim):
        sl = [slice(0, n)] * dim
        sl[d] = slice(0, n + 1)
        bc.append(full[d][tuple(sl)])
    div_c = sum(np.diff(bc[d], axis=d) for d in range(dim))
    fine = []
    for d in range(dim):
        ref = np.asarray(jil.prolong_face(jnp.asarray(bc[d]), d, dim))
        got = til.prolong_face(torch.as_tensor(bc[d]), d, dim).numpy()
        np.testing.assert_array_equal(got, ref)
        fine.append(got)
    # the fine divergence over the 2n cells with the hi faces appended from
    # the prolongation of the coarse hi face
    div_f = 0.0
    for d in range(dim):
        hi = [slice(None)] * dim
        hi[d] = slice(n, n + 1)
        cap = np.repeat(bc[d][tuple(hi)], 2, axis=[k for k in range(dim) if k != d][0])
        for k in range(dim):
            if k != d and k != [k2 for k2 in range(dim) if k2 != d][0]:
                cap = np.repeat(cap, 2, axis=k)
        div_f = div_f + np.diff(np.concatenate([fine[d], cap], axis=d), axis=d)
    assert np.abs(div_c).max() < 1e-12
    assert np.abs(div_f).max() < 1e-12
    for k in range(3):
        E = rng.standard_normal(tuple(2 * n + (0 if a == k else 1) for a in range(dim)))
        np.testing.assert_array_equal(til.restrict_edge(torch.as_tensor(E), k, dim).numpy(),
                                      np.asarray(jil.restrict_edge(jnp.asarray(E), k, dim)))
    for d in range(dim):
        F = rng.standard_normal(tuple(2 * n + (1 if a == d else 0) for a in range(dim)))
        np.testing.assert_array_equal(til.restrict_face(torch.as_tensor(F), d, dim).numpy(),
                                      np.asarray(jil.restrict_face(jnp.asarray(F), d, dim)))


def test_mhd_loads_no_jax():
    """An MHD step of each kind (MhdSimulation's CTU-CT and RK2 steps, the
    Simulation's step with constant gravity, a two-level hierarchy's coarse
    step) loads neither jax nor any castro_tpu module (a fresh process:
    this one has imported JAX)."""
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        from castro_tpu_torch.driver.amr import AmrSimulation
        from castro_tpu_torch.driver.sim import Simulation
        from castro_tpu_torch.mhd import MhdSimulation
        from castro_tpu_torch.problems import mhd_tests as mt, orszag_tang as ot
        for ctu in (1, 0):
            m = MhdSimulation(mt.alfven_params(n=8).with_ns("castro", mhd_ctu=ctu),
                              problem_init=mt.alfven_init, device="cpu")
            m.run(stop_time=1.0, max_step=1)
        s = Simulation(mt.rt_params(n=(8, 16)), problem_init=mt.rt_init, device="cpu")
        s.init_data()
        s.advance(s.estimate_dt())
        def tag(sim, u_int, level):
            x = sim.geom.cell_centers(0, 0)
            return ((x > 0.3) & (x < 0.7)).expand(u_int.shape[1:])
        p = ot.make_params(n=16).with_ns("amr", max_level=1, regrid_int=0)
        a = AmrSimulation(p, problem_init=ot.problem_init, problem_tagging=tag, device="cpu")
        a.init_data()
        a.advance(a.estimate_dt())
        bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
               or k == "jaxlib" or k == "castro_tpu" or k.startswith("castro_tpu.")]
        print("LOADED", bad)
        assert not bad, bad
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
