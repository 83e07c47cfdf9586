"""aprox19, the network of the reference's Detonation setup, with the
Helmholtz EOS: the port's burner against the JAX package's on the CPU, in
float64, within 1e-8 (mass fractions absolute, energy relative), and the
failure flags equal. The JAX side compiles its burner once (some 30 s);
the iteration counts are read from JAX for powerlaw and iso7 in
test_torch_reactions.py, where a second, capped compile is cheaper. Here
the port's own counts are checked for consistency: capped one iteration
below its largest count, exactly the zones that needed it fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.integrators.stiff import make_burner as j_make_burner
from castro_tpu.network.aprox19 import Aprox19Network as JAprox19
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.integrators.stiff import make_burner
from castro_tpu_torch.network.aprox19 import Aprox19Network

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)

KW = dict(rtol=1e-6, atol_x=1e-8, atol_e=1e-6)


def test_aprox19_helmholtz_burn_matches_jax():
    jnet, tnet = JAprox19(), Aprox19Network()
    jeos, teos = JHelm(network=jnet), HelmholtzEos(network=tnet)
    rng = np.random.default_rng(0)
    n = 4
    rho = 1e6 * rng.uniform(0.5, 2.0, n)
    T = 1.5e9 * rng.uniform(0.8, 1.2, n)
    x = rng.uniform(0.0, 1.0, (jnet.nspec, n))
    x[1::3] = 0.0  # species at exactly zero: the tie of the clips
    x /= x.sum(0)
    e = np.asarray(jeos.rt(rho=jnp.asarray(rho), T=jnp.asarray(T), xn=jnp.asarray(x)).e)
    dt = 1e-10
    tb = make_burner(tnet, teos, **KW)
    targs = tuple(torch.tensor(a) for a in (rho, T, x, e))
    xn, en, fail = tb(*targs, dt)
    steps = tb.stats.zone_steps.numpy()
    jxn, jen, jfail = j_make_burner(jnet, jeos, **KW)(*(jnp.asarray(a) for a in (rho, T, x, e)),
                                                      dt)
    np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=0, atol=1e-8)
    np.testing.assert_allclose(en.numpy(), np.asarray(jen), rtol=1e-8)
    assert fail.tolist() == np.asarray(jfail).tolist() == [False] * n
    assert steps.max() > 2
    capped = make_burner(tnet, teos, max_substeps=int(steps.max()) - 1, **KW)
    assert capped(*targs, dt)[2].tolist() == (steps == steps.max()).tolist()
