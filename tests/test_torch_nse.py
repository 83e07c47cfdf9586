"""The NSE solver (`network/nse.py`) and the Strang NSE bypass of
`network.nse=1` (`reactions/strang.py`) in the port against the JAX
package on the CPU, float64: both branches of the solver (iso7, whose
species share one Z/A, takes the 1D Newton; aprox19 the bisection on the
fugacity difference) at 20 (rho, T, Ye) points around the conditions of
tests/test_networks_heavy.py:106-150; the bypass on zones in and out of
NSE (iso7 with the gamma law through a whole react, as
tests/test_networks_heavy.py:152-190 sets it up; aprox19 with Helmholtz
through the bypass alone).

Tolerance: mass fractions within 1e-8 relative with an absolute floor of
1e-12, T* and the energy within 1e-8 relative: a `ye_of(mid, s) < ye` tie
of the bisection may fall either way at round-off. The JAX solver and
bypass run jitted (their scans recompile at every eager call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.config import Params as JParams
from castro_tpu.eos.gamma_law import GammaLawEos as JGamma
from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.network.aprox19 import Aprox19Network as JAprox19
from castro_tpu.network.iso7 import Iso7Network as JIso7
from castro_tpu.network.nse import make_nse_solver as j_make_nse
from castro_tpu.reactions.strang import StrangReactor as JStrang
from castro_tpu.state import layout_from_params as j_layout
from castro_tpu_torch.config import Params
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.network.aprox19 import Aprox19Network
from castro_tpu_torch.network.iso7 import Iso7Network
from castro_tpu_torch.network.nse import make_nse_solver, nse_ebind
from castro_tpu_torch.reactions.strang import StrangReactor
from castro_tpu_torch.state import layout_from_params

jax.config.update("jax_enable_x64", True)

RTOL = 1e-8
XFLOOR = 1e-12


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _points(seed=0, n=20):
    """rho 1e7..5e9, T 3.5e9..1.2e10, Ye 0.44..0.5, log-uniform in rho and
    T, with the corners of tests/test_networks_heavy.py among them."""
    rng = np.random.default_rng(seed)
    rho = 10.0 ** rng.uniform(7.0, np.log10(5e9), n)
    T = 10.0 ** rng.uniform(np.log10(3.5e9), np.log10(1.2e10), n)
    ye = rng.uniform(0.44, 0.5, n)
    rho[:4] = [1e9, 1e8, 1e8, 1e9]
    T[:4] = [3.5e9, 4e9, 1.2e10, 6e9]
    ye[:4] = [0.5, 0.5, 0.5, 0.46]
    return rho, T, ye


@pytest.mark.parametrize("name", ["iso7", "aprox19"])
def test_nse_matches_jax(name):
    jnet, tnet = {"iso7": (JIso7(), Iso7Network()),
                  "aprox19": (JAprox19(), Aprox19Network())}[name]
    rho, T, ye = _points()
    if name == "iso7":
        ye[:] = 0.5  # one Z/A: the charge constraint is the network's own
    ref = np.asarray(jax.jit(j_make_nse(jnet))(*(jnp.asarray(a) for a in (rho, T, ye))))
    got = make_nse_solver(tnet)(*(torch.tensor(a) for a in (rho, T, ye))).numpy()
    assert got.shape == (tnet.nspec, rho.size)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=XFLOOR)
    np.testing.assert_allclose(got.sum(0), 1.0, rtol=1e-12)
    if name == "aprox19":
        # the charge constraint holds, and both regimes are present
        ye_out = (tnet.zion / tnet.aion) @ got
        np.testing.assert_allclose(ye_out, ye, atol=1e-4)
        heavy = got[8:17].sum(0)
        assert heavy.max() > 0.5 and heavy.min() < 0.1
    eb = nse_ebind(tnet, torch.tensor(got)).numpy()
    np.testing.assert_allclose(eb, tnet.ebin @ got, rtol=1e-12)


def _iso7_state(L, eos, xn0, rho, T):
    n = rho.size
    xn = np.repeat(np.asarray(xn0, dtype=float)[:, None], n, axis=1)
    e = eos.rt(rho=torch.tensor(rho), T=torch.tensor(T), xn=torch.tensor(xn)).e.numpy()
    u = np.zeros((L.NVAR, n))
    u[L.URHO] = rho
    u[L.UTEMP] = T
    u[L.UEINT] = rho * e
    u[L.UEDEN] = rho * e
    u[L.UFS:L.UFS + xn.shape[0]] = rho[None] * xn
    return u


def test_strang_bypass_iso7_gamma_law_matches_jax():
    """Two cold zones and two NSE zones of pure Si28 at 1e9 g/cc through a
    whole react: the cold ones burn (barely), the hot ones relax to the
    Ni56-rich equilibrium and release energy."""
    def params(P):
        p = P().with_ns("network", network_name="iso7", nspec=7, nse=1, rho_nse=1e7, T_nse=4e9)
        return p.with_ns("castro", do_react=1).with_ns("amr", n_cell=(4,))

    jp, tp = params(JParams), params(Params)
    jnet, tnet = JIso7(), Iso7Network()
    jeos, teos = JGamma(gamma=5.0 / 3.0, network=jnet), GammaLawEos(gamma=5.0 / 3.0, network=tnet)
    L = layout_from_params(tp)
    xn0 = np.zeros(7)
    xn0[5] = 1.0
    u = _iso7_state(L, teos, xn0, np.full(4, 1e9), np.array([3e8, 3e8, 5e9, 5e9]))
    dt = 1e-8
    jr = JStrang(jp, jnet, jeos, j_layout(jp))
    ref = jax.jit(jr.react, static_argnums=())(jnp.asarray(u), dt)
    got = StrangReactor(tp, tnet, teos, L).react(torch.tensor(u), dt)
    assert not bool(got[3]) and not bool(ref[3])
    gu, ru = got[0].numpy(), np.asarray(ref[0])
    x_got = gu[L.UFS:L.UFS + 7] / gu[L.URHO]
    x_ref = ru[L.UFS:L.UFS + 7] / ru[L.URHO]
    np.testing.assert_allclose(x_got, x_ref, rtol=RTOL, atol=XFLOOR)
    np.testing.assert_allclose(gu[L.UEINT], ru[L.UEINT], rtol=RTOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=RTOL,
                               atol=1e-8 * np.abs(np.asarray(ref[2])).max())
    assert x_got[6, 2] > 0.5 and gu[L.UEINT, 2] > u[L.UEINT, 2]
    assert x_got[5, 0] > 0.999


def test_strang_bypass_aprox19_helmholtz_matches_jax():
    """The bypass alone (the burn's result stands in as the input) on six
    zones of aprox19 with Helmholtz: three in NSE (one past T_always_nse),
    three out (too cold, too thin), Fe54/Si28/O16 mixtures."""
    def params(P):
        return P().with_ns("network", network_name="aprox19", nspec=19, nse=1,
                           rho_nse=2e8, T_nse=5e9, T_always_nse=1e10)

    jp, tp = params(JParams), params(Params)
    jnet, tnet = JAprox19(), Aprox19Network()
    jeos, teos = JHelm(network=jnet), HelmholtzEos(network=tnet)
    rho = np.array([5e9, 1e9, 1e7, 5e9, 1e8, 2e8])
    T = np.array([8e9, 6e9, 1.1e10, 3e9, 6e9, 4.9e9])
    x = np.zeros((19, 6))
    x[15] = [1.0, 0.5, 0.2, 0.6, 0.0, 0.3]
    x[8] = [0.0, 0.5, 0.3, 0.4, 0.5, 0.3]
    x[5] = 1.0 - x[15] - x[8]
    e = teos.rt(rho=torch.tensor(rho), T=torch.tensor(T), xn=torch.tensor(x)).e.numpy()
    jr = JStrang(jp, jnet, jeos, j_layout(jp))
    args = (rho, T, x, e, x, e)
    ref = jax.jit(jr._apply_nse)(*(jnp.asarray(a) for a in args))
    got = StrangReactor(tp, tnet, teos, layout_from_params(tp))._apply_nse(
        *(torch.tensor(a) for a in args))
    assert got[2].tolist() == np.asarray(ref[2]).tolist() == [True, True, True, False, False,
                                                             False]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=RTOL, atol=XFLOOR)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=RTOL)
    np.testing.assert_array_equal(got[0].numpy()[:, 3:], x[:, 3:])
