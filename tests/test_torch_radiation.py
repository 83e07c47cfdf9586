"""The radiation modules of the port (`castro_tpu_torch/radiation/`) against
the JAX package's on the same inputs, made from a numpy seed: the flux
limiters and Eddington factors, the Purser filters, the frequency groups,
f-space advection (with the float32 no-flush case), Compton scattering,
and the gray implicit update (Cartesian, 2D RZ and 1D spherical metrics,
every BC kind the setups use); the multigroup update in
tests/test_torch_rad_multigroup.py.

The JAX multigrid runs jitted (`jit_jax_solve`: its while_loop recompiles
at every eager call); the rest of the JAX side runs eagerly. The helpers
here serve the other radiation test files.

Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per leading component
(tests/test_torch_hydro_paths.py:_assert_close's form), float32 rtol =
atol = 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.geometry import geometry_from_params as jgeom
from castro_tpu.radiation import compton as jcompton
from castro_tpu.radiation import filter as jfilter
from castro_tpu.radiation import fld as jfld
from castro_tpu.radiation import fspace as jfspace
from castro_tpu.solvers import multigrid as jmg
from castro_tpu.state import layout_from_params as jlayout

from castro_tpu_torch.config import Params
from castro_tpu_torch.geometry import geometry_from_params
from castro_tpu_torch.ops import rad_hydro
from castro_tpu_torch.radiation import compton, filter as tfilter, fld, fspace
from castro_tpu_torch.state import layout_from_params

jax.config.update("jax_enable_x64", True)


def make_jit_solve():
    """A drop-in for castro_tpu.solvers.multigrid.solve that runs each solve
    as one jitted program (re-enabled inside disable_jit), one compile per
    grid, dx and static arguments; vmapped calls batch it."""
    orig = jmg.solve
    cache = {}

    def solve(rhs, dx, *, bc_vals_lo=None, bc_vals_hi=None, acoef=None, bcoefs=None,
              beta=1.0, metric=None, **static):
        key = (tuple(dx), tuple(sorted(static.items())))
        if key not in cache:
            cache[key] = jax.jit(lambda r, bl, bh, a, b, be, m: orig(
                r, tuple(dx), bc_vals_lo=bl, bc_vals_hi=bh, acoef=a, bcoefs=b, beta=be,
                metric=m, **static))
        with jax.disable_jit(False):
            return cache[key](rhs, bc_vals_lo, bc_vals_hi, acoef, bcoefs, beta, metric)

    return solve


@pytest.fixture(scope="module")
def jit_jax_solve():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "solve", make_jit_solve())
    yield
    mp.undo()


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def close(got, ref, dtype="float64", what="", vectors=()):
    """float64: 1e-10 |ref| + 1e-10 max|ref| per leading component (per
    array for 1D arrays; the components of each index tuple in `vectors`,
    a state's momenta, share the largest of their maxima, so that a
    component that is zero but for round-off is held to its vector's
    scale); float32: rtol = atol = 2e-5."""
    got = got.detach().double().cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if dtype == "float64":
        flat = ref.reshape(ref.shape[0], -1) if ref.ndim > 1 else ref.reshape(1, -1)
        if ref.ndim > 1:
            comp = np.abs(flat).max(1)
            for v in vectors:
                comp[list(v)] = comp[list(v)].max()
            scale = comp.reshape((-1,) + (1,) * (ref.ndim - 1))
        else:
            scale = np.abs(ref).max()
        np.testing.assert_array_less(np.abs(got - ref), 1e-10 * np.abs(ref) + 1e-10 * scale
                                     + 1e-300, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5, err_msg=what)


def t64(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def rad_params(P, dim=2, n=16, dtype="float64", coord=0, **rad):
    """A radiation configuration for both packages: unit box (or RZ /
    spherical shell), gamma-law gas."""
    p = P().with_ns("amr", n_cell=(n,) * dim)
    lo = (0.1, 0.0, 0.0) if coord else (0.0,) * 3
    p = p.with_ns("geometry", prob_lo=lo, prob_hi=(1.0,) * 3, coord_sys=coord)
    p = p.with_ns("castro", do_radiation=1, lo_bc=(2,) * dim, hi_bc=(2,) * dim)
    p = p.with_ns("radiation", **rad)
    return p.with_ns("tpu", dtype=dtype)


def fld_pair(dim=2, n=16, dtype="float64", coord=0, **rad):
    """(JAX FLDRadiation, port FLDRadiation) of the same configuration."""
    jp = rad_params(JParams, dim, n, dtype, coord, **rad)
    tp = rad_params(Params, dim, n, dtype, coord, **rad)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    jr = jfld.FLDRadiation(jp, jgeom(jp, jdt), jlayout(jp))
    tr = fld.FLDRadiation(tp, geometry_from_params(tp, tdt, "cpu"), layout_from_params(tp))
    return jr, tr


@pytest.mark.parametrize("limiter", [0, 2, 12, 22, 32])
def test_fld_lambda_and_eddington_factors(limiter):
    R = np.random.default_rng(limiter).uniform(0.0, 5.0, 200)
    close(fld.fld_lambda(t64(R), limiter), jfld.fld_lambda(jnp.asarray(R), limiter))
    lam = np.asarray(jfld.fld_lambda(jnp.asarray(R), limiter))
    for closure in range(5):
        close(fld.edd_factor(t64(lam), t64(R), closure),
              jfld.edd_factor(jnp.asarray(lam), jnp.asarray(R), closure), what=f"fld {closure}")
    from castro_tpu.ops import rad_hydro as jrh

    for closure in range(4):
        close(rad_hydro.edd_factor(t64(lam), limiter, closure),
              jrh.edd_factor(jnp.asarray(lam), limiter, closure), what=f"rad_hydro {closure}")


@pytest.mark.parametrize("T", [1, 2, 3, 4])
def test_filter(T):
    f = np.random.default_rng(T).standard_normal((3, 11, 9))
    np.testing.assert_array_equal(tfilter.filter_kernel(T), jfilter.filter_kernel(T))
    for axes in (None, (1, 2), (2,)):
        close(tfilter.apply_filter(t64(f), T, axes=axes),
              jfilter.apply_filter(jnp.asarray(f), T, axes=axes), what=str(axes))
    f32 = f.astype(np.float32)
    close(tfilter.apply_filter(t64(f32, torch.float32), T, axes=(1, 2)),
          jfilter.apply_filter(jnp.asarray(f32), T, axes=(1, 2)), "float32")


def test_group_structure_and_fspace():
    for args in ((6, 1e14, 1e18), (64, 0.0, None, 1.1, 1.2089946159439433e13),
                 (5, 1e13, None, 1.3, 2e13)):
        a, b = fspace.group_structure(*args), jfspace.group_structure(*args)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-14)
    gs = fspace.group_structure(6, 1e14, 1e18)
    rng = np.random.default_rng(3)
    u = rng.uniform(0.1, 1.0, (6, 5, 7))
    a = rng.uniform(-2.0, 2.0, (6, 5, 7))
    close(fspace.dudt_fspace(t64(u), t64(a), t64(gs["dlognu"])),
          jfspace.dudt_fspace(jnp.asarray(u), jnp.asarray(a), jnp.asarray(gs["dlognu"])))
    for ftype in (1, 2):
        got, n1 = fspace.advect_in_fspace(t64(u), t64(a), gs["nugroup"], gs["dlognu"], 2.0, ftype)
        ref, n2 = jfspace.advect_in_fspace(jnp.asarray(u), jnp.asarray(a), gs["nugroup"],
                                           gs["dlognu"], 2.0, ftype)
        close(got, ref, what=f"fspace type {ftype}")
        assert n1 == int(n2) > 1
    lam = rng.uniform(0.05, 0.33, (6, 5, 7))
    close(fspace.fspace_speeds(t64(a[0]), t64(a), t64(lam), 2, 3),
          jfspace.fspace_speeds(jnp.asarray(a[0]), jnp.asarray(a), jnp.asarray(lam), 2, 3))


def test_fspace_float32_no_flush():
    """The dtype-aware guard: the reference's 1e-50 flushes to zero in
    float32 and would make 0/0; the advection stays finite and float32."""
    gs = fspace.group_structure(4, 1e14, 1e18)
    Er = np.full((4, 8), 1e-31, np.float32)
    for speed, dt in ((0.0, 2e-7), (0.3, 1e-2)):
        af = np.full((4, 8), speed, np.float32)
        got, _ = fspace.advect_in_fspace(t64(Er, torch.float32), t64(af, torch.float32),
                                         gs["nugroup"], gs["dlognu"], dt, 1)
        ref, _ = jfspace.advect_in_fspace(jnp.asarray(Er), jnp.asarray(af), gs["nugroup"],
                                          gs["dlognu"], dt, 1)
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        close(got, ref, "float32")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compton(dtype):
    gs = fspace.group_structure(16, 1e17, 1e20)
    rng = np.random.default_rng(5)
    npd = np.float64 if dtype == "float64" else np.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    T = rng.uniform(1e7, 1e9, (6, 5)).astype(npd)
    ks = rng.uniform(0.1, 10.0, (6, 5)).astype(npd)
    Er = (rng.uniform(0.0, 1.0, (16, 6, 5)) * 1e10).astype(npd)
    Er[:, 0, 0] = 0.0  # a zone with no photons skips the rescale
    got = compton.apply_inelastic_scattering(t64(Er, tdt), t64(T, tdt), t64(ks, tdt), 1e-9,
                                             gs["nugroup"], gs["xnu"], gs["dlognu"])
    ref = jcompton.apply_inelastic_scattering(jnp.asarray(Er), jnp.asarray(T), jnp.asarray(ks),
                                              1e-9, gs["nugroup"], gs["xnu"], gs["dlognu"])
    close(got[0], ref[0], dtype, "Er")
    close(got[1], ref[1], dtype, "dEr")
    assert bool(torch.isfinite(got[0]).all())


def _matter(jr, tr, dim, n, seed, dtype="float64"):
    rng = np.random.default_rng(seed)
    shape = (n,) * dim
    npd = np.float64 if dtype == "float64" else np.float32
    rho = rng.uniform(0.5, 2.0, shape).astype(npd)
    T = rng.uniform(0.5, 2.0, shape).astype(npd)
    cv = np.full(shape, 2.0, npd)
    Er = (7.5657e-15 * rng.uniform(0.2, 3.0, shape)).astype(npd)
    return rho, T, cv, cv * T, Er


BCS = {"marshak-flux": dict(lo_bc=(104, 102, 0), hi_bc=(102, 101, 0), lo_bcval=(1e-5, 0, 0),
                            hi_bcval=(2e-5, 3e-15, 0)),
       "neumann-dirichlet": dict(lo_bc=(102, 101, 0), hi_bc=(105, 101, 0),
                                 lo_bcval=(0.0, 1e-14, 0), hi_bcval=(0.0, 5e-15, 0))}


@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
@pytest.mark.parametrize("geom", ["cartesian", "rz"])
def test_gray_update(jit_jax_solve, geom, bcs):
    coord = 1 if geom == "rz" else 0
    jr, tr = fld_pair(2, 16, coord=coord, const_kappa_p=5.0, const_kappa_r=30.0,
                      kappa_r_exp_n=0.5, limiter=2, outer_iters=3, **BCS[bcs])
    assert (tr.geom_metric() is None) == (coord == 0)
    if coord:
        for a, b in zip(tr.geom_metric()["areas"], jr.geom_metric()["areas"]):
            close(a, b)
        close(tr.geom_metric()["vol"], jr.geom_metric()["vol"])
    rho, T, cv, e, Er = _matter(jr, tr, 2, 16, seed=7)
    j = [jnp.asarray(a) for a in (Er, rho, e, T, cv)]
    ref = jr.gray_update(*j, 1e-3, metric=jr.geom_metric(), keep_flux=True)
    got = tr.gray_update(*(t64(a) for a in (Er, rho, e, T, cv)), 1e-3, metric=tr.geom_metric(),
                         keep_flux=True)
    for k, name in enumerate(("Er", "e", "T")):
        close(got[k], ref[k], what=name)
    for d in range(2):
        close(got[3][d], ref[3][d], what=f"flux {d}")
    assert len(tr.solve_stats) == 3 and all(c_ > 1 for c_, _ in tr.solve_stats)
    close(tr.estdt(got[0], t64(rho), got[1], t64(cv), got[2]),
          jr.estdt(ref[0], j[1], ref[1], j[4], ref[2]))


def test_spherical_gray_update_with_eos(jit_jax_solve):
    """1D spherical, the exact T(e) of an EOS callback."""
    jr, tr = fld_pair(1, 32, coord=2, const_kappa_p=2.0, const_kappa_r=10.0, limiter=0,
                      outer_iters=4, lo_bc=(102,), hi_bc=(104,), hi_bcval=(1e-4, 0, 0))
    rho, T, cv, e, Er = _matter(jr, tr, 1, 32, seed=8)

    class E:
        def __init__(self, lib, rho, cv):
            self.lib, self.rho, self.cv = lib, rho, cv

        def __call__(self, e_k):
            from types import SimpleNamespace

            return SimpleNamespace(T=e_k / self.cv, cv=self.cv + 0.0 * e_k)

    ref = jr.gray_update(*(jnp.asarray(a) for a in (Er, rho, e, T, cv)), 1e-3,
                         eos_re=E(jnp, jnp.asarray(rho), jnp.asarray(cv)),
                         metric=jr.geom_metric())
    got = tr.gray_update(*(t64(a) for a in (Er, rho, e, T, cv)), 1e-3,
                         eos_re=E(torch, t64(rho), t64(cv)), metric=tr.geom_metric())
    for k in range(3):
        close(got[k], ref[k], what=str(k))
