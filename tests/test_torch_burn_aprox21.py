"""aprox21 burned through `StrangReactor.react` with the Helmholtz EOS,
in the port against the JAX package on the CPU, float64 (subch's burn,
the same check, is test_torch_burn_subch.py): four zones, Si28..Ni56 with
Cr56 and Fe56 and trace free nucleons, a species at exactly zero among
them (the tie of the clips); mass fractions within 1e-8 absolute, the
energy and the rates within 1e-8 relative, the failure flag equal. The
JAX react runs jitted (its burner compiles once, some 40 s for aprox21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.config import Params as JParams
from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.network import make_network as j_make_network
from castro_tpu.reactions.strang import StrangReactor as JStrang
from castro_tpu.state import layout_from_params as j_layout
from castro_tpu_torch.config import Params
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.network import make_network
from castro_tpu_torch.reactions.strang import StrangReactor
from castro_tpu_torch.state import layout_from_params

jax.config.update("jax_enable_x64", True)

CASES = {
    # name: (rho range, T range, dt, seeded species, trace species)
    "aprox21": ((5e6, 2e7), (2.7e9, 3.3e9), 1e-10, (15, 16, 19, 20, 8, 5), (17, 18)),
    "subch": ((1e5, 1e6), (3e8, 6e8), 1e-8, (0, 1, 2, 13, 16), ()),
}
NSPEC = {"aprox21": 21, "subch": 17}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def react_case(name):
    """One react of the network `name` in the port and in JAX, held."""
    (rlo, rhi), (tlo, thi), dt, seeded, trace = CASES[name]

    def params(P):
        return P().with_ns("network", network_name=name, nspec=NSPEC[name]).with_ns(
            "castro", do_react=1).with_ns("amr", n_cell=(4,))

    jp, tp = params(JParams), params(Params)
    jnet, tnet = j_make_network(jp), make_network(tp)
    jeos, teos = JHelm(network=jnet), HelmholtzEos(network=tnet)
    L = layout_from_params(tp)
    rng = np.random.default_rng(7)
    n = 4
    rho = np.exp(rng.uniform(np.log(rlo), np.log(rhi), n))
    T = rng.uniform(tlo, thi, n)
    x = np.zeros((tnet.nspec, n))
    x[list(seeded)] = rng.uniform(0.05, 1.0, (len(seeded), n))
    x[seeded[-1], 0] = 0.0
    x[list(trace)] = 1e-7
    x /= x.sum(0)
    e = teos.rt(rho=torch.tensor(rho), T=torch.tensor(T), xn=torch.tensor(x)).e.numpy()
    u = np.zeros((L.NVAR, n))
    u[L.URHO], u[L.UTEMP] = rho, T
    u[L.UEINT] = u[L.UEDEN] = rho * e
    u[L.UFS:L.UFS + tnet.nspec] = rho * x
    jr = JStrang(jp, jnet, jeos, j_layout(jp))
    ref = jax.jit(jr.react)(jnp.asarray(u), dt)
    got = StrangReactor(tp, tnet, teos, L).react(torch.tensor(u), dt)
    gu, ru = got[0].numpy(), np.asarray(ref[0])
    sl = slice(L.UFS, L.UFS + tnet.nspec)
    np.testing.assert_allclose(gu[sl] / rho, ru[sl] / rho, rtol=0, atol=1e-8)
    np.testing.assert_allclose(gu[L.UEINT], ru[L.UEINT], rtol=1e-8)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-8)
    assert bool(got[3]) == bool(ref[3]) is False
    assert np.abs(got[2].numpy()).min() > 0.0  # every zone burned


def test_react_matches_jax():
    react_case("aprox21")
