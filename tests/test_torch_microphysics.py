"""The port's microphysics against the JAX package on the CPU, float64: the
Helmholtz EOS (rt, re, rp, with and without the Coulomb corrections) on a
(rho, T, X) grid from ideal through degenerate to radiation-dominated
zones, and the RHS of powerlaw, iso7, aprox13 and aprox19 at the rho/T
points of tests/test_reactions.py and tests/test_networks_heavy.py and on
a grid across the burning range.

Tolerances: the EOS state (p, e, h, cs, gam1) within 1e-10 relative; its
derivatives (dp/drho|e, dp/de, cv) within 1e-9: they come from the table
interpolant's slope, a sum of 16 weighted table values that cancels to a
small number (the XLA CPU code of the JAX package contracts its
multiply-adds, which moves it by ~1e-11), and dp/drho|e subtracts two such
terms. re() and rp() are held where T(e) is conditioned (d ln e /
d ln T above 1e-3): T within 1e-9 and the state within 1e-10. In the
degenerate zones, T(e) is ill-conditioned (d ln e / d ln T reaches 1e-8
at rho ~ 1e9 and T ~ 1e5, so that a rounding of e moves T by 1e-8), and
the two packages' Newton iterates differ there by that much. The network
RHS within 1e-10 of each output's largest magnitude (a net rate near
equilibrium is a cancelling difference of large forward and reverse
terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.network.aprox13 import Aprox13Network as JAprox13
from castro_tpu.network.aprox19 import Aprox19Network as JAprox19
from castro_tpu.network.iso7 import Iso7Network as JIso7
from castro_tpu.network.powerlaw import PowerLawNetwork as JPowerLaw
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.network.aprox13 import Aprox13Network
from castro_tpu_torch.network.aprox19 import Aprox19Network
from castro_tpu_torch.network.iso7 import Iso7Network
from castro_tpu_torch.network.powerlaw import PowerLawNetwork

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)

NETWORKS = {"iso7": (JIso7, Iso7Network), "aprox13": (JAprox13, Aprox13Network),
            "aprox19": (JAprox19, Aprox19Network)}
STATE = ("p", "e", "h", "cs", "gam1")
DERIVS = ("dpdr_e", "dpde", "cv")


def _grid(nspec, seed=0):
    """rho 1e-2..1e9 g/cm^3 by T 1e5..3e9 K (7 x 7 points), random mass
    fractions with one species at exactly zero."""
    rng = np.random.default_rng(seed)
    rho, T = np.meshgrid(np.logspace(-2, 9, 7), np.logspace(5, np.log10(3e9), 7))
    rho, T = rho.ravel(), T.ravel()
    x = rng.uniform(0.0, 1.0, (nspec, rho.size))
    x[min(1, nspec - 1)] = 0.0
    return rho, T, x / x.sum(0)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


@pytest.mark.parametrize("coulomb", [True, False], ids=["coulomb", "no-coulomb"])
@pytest.mark.parametrize("net", list(NETWORKS))
def test_helmholtz_matches_jax(net, coulomb):
    jn, tn = NETWORKS[net][0](), NETWORKS[net][1]()
    je, te = JHelm(network=jn, use_coulomb=coulomb), HelmholtzEos(network=tn,
                                                                  use_coulomb=coulomb)
    rho, T, x = _grid(jn.nspec)
    js = je.rt(rho=jnp.asarray(rho), T=jnp.asarray(T), xn=jnp.asarray(x))
    ts = te.rt(rho=torch.tensor(rho), T=torch.tensor(T), xn=torch.tensor(x))
    for k in STATE:
        assert _rel(getattr(ts, k), getattr(js, k)) < 1e-10, ("rt", k)
    for k in DERIVS:
        assert _rel(getattr(ts, k), getattr(js, k)) < 1e-9, ("rt", k)
    # the inversions, from the JAX state's e and p, where T(e) is
    # conditioned (d ln e / d ln T above 1e-3; module docstring)
    cond = np.asarray(js.e) / (T * np.asarray(js.cv))
    ok = cond < 1e3
    assert ok.sum() > 20
    rho, x = rho[ok], x[:, ok]
    for mode, key in (("re", "e"), ("rp", "p")):
        target = np.asarray(getattr(js, key))[ok]
        jr = getattr(je, mode)(jnp.asarray(rho), jnp.asarray(target), jnp.asarray(x))
        tr = getattr(te, mode)(torch.tensor(rho), torch.tensor(target), torch.tensor(x))
        assert _rel(tr.T, jr.T) < 1e-9, (mode, "T")
        assert _rel(getattr(tr, key), getattr(jr, key)) < 1e-10, (mode, key)


def _rhs_close(tn, jn, rho, T, x):
    jx, je = jn.rhs(jnp.asarray(rho), jnp.asarray(T), jnp.asarray(x))
    tx, te = tn.rhs(torch.tensor(rho), torch.tensor(T), torch.tensor(x))
    for got, ref in ((tx, jx), (te, je)):
        got, ref = got.numpy(), np.asarray(ref)
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - ref) <= 1e-10 * np.abs(ref).max()), np.abs(got - ref).max()


@pytest.mark.parametrize("net", list(NETWORKS))
def test_network_rhs_matches_jax(net):
    jn, tn = NETWORKS[net][0](), NETWORKS[net][1]()
    rho, T, x = _grid(jn.nspec, seed=1)
    keep = T >= 1e7  # the burning range
    _rhs_close(tn, jn, rho[keep], T[keep], x[:, keep])


# rho/T points of tests/test_reactions.py and tests/test_networks_heavy.py
POINTS = {
    "iso7": [(1e5, 2e8), (1e7, 3.5e9), (1e6, 2.5e9)],
    "aprox13": [(1e6, 2e8), (1e5, 2e8), (1e7, 9e9), (1e4, 3e8), (1e6, 3e8)],
    "aprox19": [(150.0, 1.5e7), (100.0, 2e7), (100.0, 5e7), (1e6, 3e9)],
}


@pytest.mark.parametrize("net", list(NETWORKS))
def test_network_rhs_at_the_reference_points(net):
    jn, tn = NETWORKS[net][0](), NETWORKS[net][1]()
    rho, T = (np.array(v) for v in zip(*POINTS[net]))
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 1.0, (jn.nspec, rho.size))
    x[: jn.nspec // 2] *= 10.0  # the light species dominate, as at these points
    _rhs_close(tn, jn, rho, T, x / x.sum(0))


def test_powerlaw_rhs_matches_jax():
    kw = dict(rtilde=5.0, nu=4.0, specific_q_burn=20.0, T_burn_ref=1.5, rho_burn_ref=1.0,
              f_act=1.0)
    jn, tn = JPowerLaw(**kw), PowerLawNetwork(**kw)
    rho = np.array([0.5, 1.0, 2.0, 1.0])
    T = np.array([4.0, 1.6, 0.2, 1.5])  # above, at and below activation
    x = np.array([[1.0, 0.7, 1.0, 0.3], [0.0, 0.3, 0.0, 0.5], [0.0, 0.0, 0.0, 0.2]])
    _rhs_close(tn, jn, rho, T, x)
