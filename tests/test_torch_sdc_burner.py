"""The forced burner of the PyTorch port (`integrators/stiff.py:
make_burner(with_forcing=True)`, the burn of the SDC couplings) against the
JAX package's on the CPU, on powerlaw and iso7 zones with the gamma law,
with equal step counts. (`tests/test_torch_sdc_react.py` holds the SDC
steps of reacting states.)

Tolerances, float64: the burn within 1e-8 of |jax| (mass fractions 1e-8
absolute), its failure flags and iteration counts exactly (the count is
read from JAX by capping its loop one iteration below the port's count:
exactly the zones that need that many fail). The JAX burner runs eagerly,
its loop compiled once, as the JAX package's own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.gamma_law import GammaLawEos as JGamma
from castro_tpu.integrators.stiff import make_burner as j_make_burner
from castro_tpu.network.iso7 import Iso7Network as JIso7
from castro_tpu.network.powerlaw import PowerLawNetwork as JPowerLaw
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.integrators.stiff import make_burner
from castro_tpu_torch.network.iso7 import Iso7Network
from castro_tpu_torch.network.powerlaw import PowerLawNetwork

jax.config.update("jax_enable_x64", True)

TOL = dict(rtol=1e-8, atol=1e-8)
PL = dict(rtilde=10.0, nu=4.0, specific_q_burn=5.0)
# name: (jax network, port network, rho, T, dt); 6 zones each, gamma law 1.4
CASES = {
    "powerlaw": (lambda: JPowerLaw(**PL), lambda: PowerLawNetwork(**PL), 1.0, 3.0, 4e-3),
    "iso7": (JIso7, Iso7Network, 1e7, 1.5e9, 2e-8),
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _zones(jnet, jeos, rho0, T0, dt, n=6, seed=0):
    """Seeded zones about (rho0, T0) and an advective forcing of the size
    of a burn's own change over dt: the species' forcing sums to zero (the
    advection of a mass fraction moves no mass), the energy's is +-5% of e
    over dt."""
    rng = np.random.default_rng(seed)
    rho = rho0 * rng.uniform(0.5, 2.0, n)
    T = T0 * rng.uniform(0.8, 1.2, n)
    x = rng.uniform(0.0, 1.0, (jnet.nspec, n))
    x[1::3] = 0.0  # species at exactly zero: the tie of the clips
    x /= x.sum(0)
    e = np.asarray(jeos.rt(rho=jnp.asarray(rho), T=jnp.asarray(T), xn=jnp.asarray(x)).e)
    xf = rng.uniform(-0.05, 0.05, (jnet.nspec, n)) / dt
    xf -= xf.mean(0)
    ef = rng.uniform(-0.05, 0.05, n) * e / dt
    return rho, T, x, e, xf, ef


@pytest.fixture(scope="module", params=list(CASES))
def forced_case(request):
    jnet_f, tnet_f, rho0, T0, dt = CASES[request.param]
    jnet, tnet = jnet_f(), tnet_f()
    jeos, teos = JGamma(1.4, network=jnet), GammaLawEos(1.4, network=tnet)
    rho, T, x, e, xf, ef = _zones(jnet, jeos, rho0, T0, dt)
    kw = dict(rtol=1e-6, atol_x=1e-8, atol_e=1e-6, with_forcing=True)
    tb = make_burner(tnet, teos, **kw)
    targs = tuple(torch.tensor(a) for a in (rho, T, x, e))
    got = tb(*targs, dt, xdot_force=torch.tensor(xf), edot_force=torch.tensor(ef))
    steps = tb.stats.zone_steps.numpy()
    # the same zones unforced, to see that the forcing moved the burn
    free = make_burner(tnet, teos, **dict(kw, with_forcing=False))(*targs, dt)
    args = tuple(jnp.asarray(a) for a in (rho, T, x, e))
    fkw = dict(xdot_force=jnp.asarray(xf), edot_force=jnp.asarray(ef))
    ref = j_make_burner(jnet, jeos, **kw)(*args, dt, **fkw)
    capped = j_make_burner(jnet, jeos, max_substeps=int(steps.max()) - 1, **kw)(*args, dt,
                                                                                **fkw)
    return request.param, got, ref, steps, capped, free


def test_forced_burner_matches_jax(forced_case):
    name, (xn, e, fail), (jxn, je, jfail), _, _, (xn0, e0, _) = forced_case
    np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=0, atol=TOL["atol"],
                               err_msg=name)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=TOL["rtol"], err_msg=name)
    assert fail.tolist() == np.asarray(jfail).tolist()
    assert not fail.any()
    assert abs(float(xn.sum(0).max()) - 1.0) < 1e-12
    # the forcing changed the outcome far beyond the tolerance
    assert float((e - e0).abs().max()) > 1e3 * TOL["rtol"] * float(e.abs().max())


def test_forced_burner_substeps_match_jax(forced_case):
    """The zones that need the port's largest iteration count are exactly
    those JAX fails when its loop stops one iteration short."""
    name, _, _, steps, (_, _, jfail_capped), _ = forced_case
    assert steps.max() > 2, name
    assert np.asarray(jfail_capped).tolist() == (steps == steps.max()).tolist(), \
        (name, steps.tolist())
