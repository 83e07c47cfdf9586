"""The initial-model generators of the port (`castro_tpu_torch/utils/
initial_models.py`) against the JAX package's on the CPU, float64: toy_atm
with the Helmholtz EOS (xrb_mixed's layer) and the gamma law
(convective_flame's), hse_plane_parallel isentropic (reacting_bubble's)
and isothermal, isentrope_through, hse_spherical with composition and
temperature callbacks, wd_mass and wd_model_for_mass at a small shell
count, and model_to_grid.

Tolerance: every column within 1e-10 of the JAX column, relative (the
marches keep the JAX package's iteration counts and stopping tests; the
two Helmholtz EOSes agree to 1e-10, tests/test_torch_microphysics.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.gamma_law import GammaLawEos as JGamma
from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.network.aprox13 import Aprox13Network as JAprox13
from castro_tpu.network.powerlaw import PowerLawNetwork as JPowerLaw
from castro_tpu.network.rprox import RproxNetwork as JRprox
from castro_tpu.utils import initial_models as jim
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.network.aprox13 import Aprox13Network
from castro_tpu_torch.network.powerlaw import PowerLawNetwork
from castro_tpu_torch.network.rprox import RproxNetwork
from castro_tpu_torch.utils import initial_models as tim

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eoses():
    """(jax EOS, port EOS) pairs: Helmholtz with rprox and aprox13, the
    gamma law 1.4 with powerlaw."""
    pl = dict(rtilde=100.0, nu=4.0, specific_q_burn=1.0e8, T_burn_ref=1.0, rho_burn_ref=1.0,
              f_act=1.2)
    return {"rprox": (JHelm(network=JRprox()), HelmholtzEos(network=RproxNetwork())),
            "aprox13": (JHelm(network=JAprox13()), HelmholtzEos(network=Aprox13Network())),
            "powerlaw": (JGamma(1.4, network=JPowerLaw(**pl)),
                         GammaLawEos(1.4, network=PowerLawNetwork(**pl)))}


def _same_model(got, ref, keys=None):
    keys = keys if keys is not None else [k for k in ref if np.ndim(ref[k]) == 1]
    assert set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=RTOL, atol=0, err_msg=k)


def test_toy_atm_helmholtz_matches_jax(eoses):
    """xrb_mixed's layer: Ni56 ash under an H/He column (rprox), 48 cells
    across the transition and into the isentropic top."""
    z = np.linspace(1300.0, 1600.0, 48)
    xn_star = np.zeros(10)
    xn_star[7] = 1.0
    xn_base = np.zeros(10)
    xn_base[9], xn_base[8], xn_base[0] = 0.7, 0.28, 0.02
    args = (z, 3.43e6, 1.0e9, 2.0e8, 8.0e6, 1450.0 - 1300.0, 12.0, xn_star, xn_base, -2.45e14)
    ref = jim.toy_atm(eoses["rprox"][0], *args)
    got = tim.toy_atm(eoses["rprox"][1], *args)
    _same_model(got, ref)
    assert got["temperature"][-1] < got["temperature"].max()  # the adiabat cooled the top


def test_toy_atm_gamma_law_matches_jax(eoses):
    """convective_flame's atmosphere (powerlaw species, unit scale)."""
    z = np.linspace(0.2, 38.2, 64)
    xn_star = np.array([0.0, 0.0, 1.0])
    xn_base = np.array([1.0, 0.0, 0.0])
    args = (z, 1.0, 0.75, 1.0, 1.0e-2, 1.25, 0.2, xn_star, xn_base, -4.2e7)
    _same_model(tim.toy_atm(eoses["powerlaw"][1], *args),
                jim.toy_atm(eoses["powerlaw"][0], *args))


@pytest.mark.parametrize("isentropic", [True, False], ids=["isentropic", "isothermal"])
def test_hse_plane_parallel_matches_jax(eoses, isentropic):
    """reacting_bubble's C/O atmosphere (aprox13, Helmholtz): isentropic
    below 1.8e8 cm and isothermal above, or isothermal throughout."""
    z = np.linspace(1.125e6, 3.6e8, 40)
    xn0 = np.zeros(13)
    xn0[1], xn0[2] = 0.3, 0.7
    kw = dict(isentropic_until=float(z[0]) + 1.8e8, T_min=1.0e7) if isentropic else {}
    ref = jim.hse_plane_parallel(eoses["aprox13"][0], z, 2.6e9, 6.0e8, -1.5e10,
                                 lambda zz: xn0, **kw)
    got = tim.hse_plane_parallel(eoses["aprox13"][1], z, 2.6e9, 6.0e8, -1.5e10,
                                 lambda zz: xn0, **kw)
    _same_model(got, ref)
    assert got["pressure"][1] < got["pressure"][0]


def test_isentrope_through_matches_jax(eoses):
    xn = np.zeros(13)
    xn[1], xn[2] = 0.5, 0.5
    ref = jim.isentrope_through(eoses["aprox13"][0], 1e7, 5e8, xn, npts=48)
    got = tim.isentrope_through(eoses["aprox13"][1], 1e7, 5e8, xn, npts=48)
    _same_model(got, ref, keys=("rho", "T", "p"))
    assert got["p"][0] < 0.3 * got["p"].max()


def _wd_callbacks(pkg, M_core):
    """A C/O core under a He shell hung on the enclosed mass, the shell
    hotter (the set-up of castro_tpu/problems/subchandra.py)."""
    co, he = np.zeros(13), np.zeros(13)
    co[1] = co[2] = 0.5
    he[0] = 1.0
    if pkg == "jax":
        co_a, he_a = jnp.asarray(co), jnp.asarray(he)
        return (lambda m: jnp.where(m <= M_core, co_a, he_a),
                lambda rho: jnp.where(rho > 1e5, 1e8, 3e8))
    co_t, he_t = torch.tensor(co), torch.tensor(he)
    return (lambda m: torch.where(m <= M_core, co_t, he_t),
            lambda rho: torch.where(rho > 1e5, torch.tensor(1e8, dtype=torch.float64),
                                    torch.tensor(3e8, dtype=torch.float64)))


def test_hse_spherical_and_wd_mass_match_jax(eoses):
    """A 40-shell white dwarf out to 1.2e9 cm, past its floor."""
    M_core = 0.8 * 1.989e33
    r = np.linspace(1.5e7, 1.2e9, 40)
    jx, jT = _wd_callbacks("jax", M_core)
    tx, tT = _wd_callbacks("torch", M_core)
    ref = jim.hse_spherical(eoses["aprox13"][0], r, 3e7, 1e8, jx, T_of_rho=jT, rho_cutoff=1e3)
    got = tim.hse_spherical(eoses["aprox13"][1], r, 3e7, 1e8, tx, T_of_rho=tT, rho_cutoff=1e3)
    _same_model(got, ref, keys=("density", "temperature", "pressure", "mass", "spec_0",
                                "spec_1"))
    assert got["density"][-1] == 1e3  # the floor tail
    assert tim.wd_mass(got) == pytest.approx(jim.wd_mass(ref), rel=RTOL)
    assert tim.wd_mass(got) > M_core  # the shell is on


def test_wd_model_for_mass_matches_jax(eoses):
    """Four bisection steps of the central density toward 0.9 Msun."""
    M = 0.9 * 1.989e33
    r = np.linspace(1.5e7, 1.2e9, 32)
    jx, jT = _wd_callbacks("jax", 0.8 * 1.989e33)
    tx, tT = _wd_callbacks("torch", 0.8 * 1.989e33)
    kw = dict(rho_c_lo=1e6, rho_c_hi=1e8, iters=4, rho_cutoff=1e3)
    ref = jim.wd_model_for_mass(eoses["aprox13"][0], r, M, 1e8, jx, T_of_rho=jT, **kw)
    got = tim.wd_model_for_mass(eoses["aprox13"][1], r, M, 1e8, tx, T_of_rho=tT, **kw)
    assert got["density"][0] == pytest.approx(float(ref["density"][0]), rel=RTOL)
    _same_model(got, ref, keys=("density", "mass"))


def test_model_to_grid():
    model = {"r": np.array([0.0, 1.0, 2.0]), "density": np.array([3.0, 2.0, 1.0]),
             "mass": np.array([0.0, 1.0, 4.0]), "note": np.zeros((2, 2))}
    got = tim.model_to_grid(model, [0.5, 1.5])
    assert set(got) == {"density", "mass"}
    np.testing.assert_array_equal(got["density"], [2.5, 1.5])
    np.testing.assert_array_equal(got["mass"], [0.5, 2.5])
