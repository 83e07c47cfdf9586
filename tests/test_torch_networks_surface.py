"""The surface-burning networks of the port against the JAX package on the
CPU, float64: triple_alpha_plus_cago, rprox and nova, their RHS (dX/dt and
the energy rate) on seeded (rho, T, X) across each network's burning
range, one stiff burn of triple_alpha with the Helmholtz EOS (rprox's and
nova's in test_torch_burn_surface.py: the JAX burner compiles for some 20
s a network), and `make_network`'s dispatch.

Tolerances: the RHS within 1e-10 of each output's largest magnitude (a
net rate near equilibrium cancels large forward and reverse terms,
tests/test_torch_microphysics.py); one burn within 1e-8 (mass fractions
1e-8 absolute, e 1e-8 relative) with equal failure flags, the burner's
own agreement (tests/test_torch_reactions.py:59).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.integrators.stiff import make_burner as j_make_burner
from castro_tpu.network.nova import NovaNetwork as JNova
from castro_tpu.network.rprox import RproxNetwork as JRprox
from castro_tpu.network.triple_alpha import TripleAlphaCagoNetwork as JTripleAlpha
from castro_tpu_torch.config import Params
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.integrators.stiff import make_burner
from castro_tpu_torch.network import make_network
from castro_tpu_torch.network.aprox21 import Aprox21Network
from castro_tpu_torch.network.subch import SubchNetwork
from castro_tpu_torch.network.nova import NovaNetwork
from castro_tpu_torch.network.rprox import RproxNetwork
from castro_tpu_torch.network.triple_alpha import TripleAlphaCagoNetwork

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# name: (jax network, port network, (log10 rho range), (log10 T range),
# one burn's (rho, T))
NETWORKS = {
    "triple_alpha": (JTripleAlpha, TripleAlphaCagoNetwork, (4, 8), (8.0, 9.5), (1e6, 6e8)),
    "rprox": (JRprox, RproxNetwork, (3, 7), (7.5, 9.3), (1e6, 5e8)),
    "nova": (JNova, NovaNetwork, (1, 5), (7.0, 8.7), (1e3, 2e8)),
}
RHS_TOL = 1e-10
BURN_TOL = 1e-8


def _points(nspec, log_rho, log_T, seed):
    """An 8 x 8 (rho, T) grid over the ranges; random mass fractions with
    one species at exactly zero."""
    rng = np.random.default_rng(seed)
    rho, T = np.meshgrid(np.logspace(*log_rho, 8), np.logspace(*log_T, 8))
    rho, T = rho.ravel(), T.ravel()
    x = rng.uniform(0.0, 1.0, (nspec, rho.size))
    x[min(2, nspec - 1)] = 0.0
    return rho, T, x / x.sum(0)


@pytest.mark.parametrize("net", list(NETWORKS))
def test_network_rhs_matches_jax(net):
    jcls, tcls, log_rho, log_T, _ = NETWORKS[net]
    jn, tn = jcls(), tcls()
    assert tn.spec_names == jn.spec_names
    np.testing.assert_array_equal(tn.aion, np.asarray(jn.aion))
    np.testing.assert_array_equal(tn.zion, np.asarray(jn.zion))
    np.testing.assert_allclose(tn.ebin, np.asarray(jn.ebin), rtol=1e-15)
    rho, T, x = _points(jn.nspec, log_rho, log_T, seed=len(net))
    jx, je = jn.rhs(jnp.asarray(rho), jnp.asarray(T), jnp.asarray(x))
    tx, te = tn.rhs(torch.tensor(rho), torch.tensor(T), torch.tensor(x))
    for what, got, ref in (("xdot", tx, jx), ("edot", te, je)):
        got, ref = got.numpy(), np.asarray(ref)
        assert np.all(np.isfinite(got)), what
        assert np.abs(ref).max() > 0.0, what
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= RHS_TOL, (what, err)


def burn_matches_jax(net):
    """One make_burner burn of 6 zones around the network's (rho, T) with
    the Helmholtz EOS, as StrangReactor calls it, for a hundredth of the
    zones' shortest energy time e / |de/dt| (a burn of a few substeps)."""
    jcls, tcls, _, _, (rho0, T0) = NETWORKS[net]
    jn, tn = jcls(), tcls()
    jeos, teos = JHelm(network=jn), HelmholtzEos(network=tn)
    rng = np.random.default_rng(11)
    rho = rho0 * rng.uniform(0.7, 1.4, 6)
    T = T0 * rng.uniform(0.9, 1.1, 6)
    x = rng.uniform(0.0, 1.0, (jn.nspec, 6))
    x /= x.sum(0)
    e = np.asarray(jeos.rt(rho=jnp.asarray(rho), T=jnp.asarray(T), xn=jnp.asarray(x)).e)
    _, edot = jn.rhs(jnp.asarray(rho), jnp.asarray(T), jnp.asarray(x))
    dt = 1e-2 * float(np.min(e / np.abs(np.asarray(edot))))
    kw = dict(rtol=1e-6, atol_x=1e-8, atol_e=1e-6)
    xn, e_new, fail = make_burner(tn, teos, **kw)(*(torch.tensor(a) for a in (rho, T, x, e)),
                                                 dt)
    jxn, je_new, jfail = j_make_burner(jn, jeos, **kw)(
        *(jnp.asarray(a) for a in (rho, T, x, e)), dt)
    assert not bool(np.asarray(jfail).any())
    assert fail.tolist() == np.asarray(jfail).tolist()
    np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=0, atol=BURN_TOL)
    np.testing.assert_allclose(e_new.numpy(), np.asarray(je_new), rtol=BURN_TOL)
    # the burn released energy
    assert np.abs(e_new.numpy() - e).max() > 1e-4 * np.abs(e).max()


def test_one_burn_matches_jax():
    burn_matches_jax("triple_alpha")


@pytest.mark.parametrize("name,cls,nspec", [
    ("triple_alpha", TripleAlphaCagoNetwork, 4),
    ("triple_alpha_plus_cago", TripleAlphaCagoNetwork, 4),
    ("rprox", RproxNetwork, 10), ("nova", NovaNetwork, 14),
    ("aprox21", Aprox21Network, 21), ("subch", SubchNetwork, 17)])
def test_make_network_dispatch(name, cls, nspec):
    net = make_network(Params().with_ns("network", network_name=name))
    assert isinstance(net, cls) and net.nspec == nspec and net.reactive


def test_make_network_unknown_raises():
    with pytest.raises(ValueError, match="unknown network"):
        make_network(Params().with_ns("network", network_name="aprox99"))
