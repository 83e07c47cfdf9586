"""The microphysics that completes ROADMAP item 7 in the port against the
JAX package on the CPU, float64: the multigamma, polytrope (types 0, 1,
2) and rad_power_law EOSes in every mode they have, through `make_eos`
from `Params` and from an inputs text (`eos.species_gammas` and the
rad_power_law keys arrive as numbers); the aprox21 and subch RHS; the
network dispatch; the model-file reader.

Tolerances: every EOS field within 1e-12 relative (each field's largest
magnitude as the floor); the RHS within 1e-10 (each species' rate against
the largest rate, the energy relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.config import Params as JParams
from castro_tpu.config import parse_inputs_text as j_parse
from castro_tpu.eos import make_eos as j_make_eos
from castro_tpu.network import make_network as j_make_network
from castro_tpu.utils.model_parser import InitialModel as JModel
from castro_tpu_torch.config import Params, parse_inputs_text
from castro_tpu_torch.eos import (MultigammaEos, PolytropeEos, RadPowerLawEos,
                                  make_eos)
from castro_tpu_torch.network import make_network
from castro_tpu_torch.network.aprox21 import Aprox21Network
from castro_tpu_torch.network.subch import SubchNetwork
from castro_tpu_torch.utils.model_parser import InitialModel

jax.config.update("jax_enable_x64", True)

FIELDS = ("rho", "T", "p", "e", "h", "gam1", "cs", "dpdr_e", "dpde", "dpdT", "dedT", "cv",
          "cp", "mu", "abar", "zbar")

# every EOS's modes: its own and those it takes from the gamma law
ALL_MODES = ("rt", "re", "rp", "rh", "tp", "ph")
EOS_CASES = {
    "multigamma": (dict(eos_name="multigamma"), dict(network_name="general_null",
                                                     spec_names=("X", "A", "B")),
                   {"eos.species_gammas": (1.666, 1.4, 1.3)}),
    "polytrope0": (dict(eos_name="polytrope", polytrope_K=2.5e12, polytrope_gamma=1.4), {}, {}),
    "polytrope1": (dict(eos_name="polytrope", polytrope_type=1, polytrope_mu_e=2.0), {}, {}),
    "polytrope2": (dict(eos_name="polytrope", polytrope_type=2, polytrope_mu_e=2.1), {}, {}),
    "rad_power_law": (dict(eos_name="rad_power_law", eos_gamma=1.5), {},
                      {"eos.const_c_v": 2.0e8, "eos.c_v_exp_m": 0.5, "eos.c_v_exp_n": -1.5}),
}


def _params(P, case):
    eos, net, extra = EOS_CASES[case]
    p = P().with_ns("eos", **eos)
    if net:
        p = p.with_ns("network", **net)
    return p.replace(extra=dict(p.extra, **extra))


def _same_state(got, ref, rtol=1e-12):
    for f in FIELDS:
        g = np.broadcast_to(getattr(got, f).numpy(), np.shape(getattr(ref, f)))
        r = np.asarray(getattr(ref, f))
        scale = np.abs(r).max() if r.size else 0.0
        assert np.all(np.abs(g - r) <= rtol * np.abs(r) + 1e-14 * scale), f


@pytest.mark.parametrize("case", list(EOS_CASES))
def test_eos_modes_match_jax(case):
    jp, tp = _params(JParams, case), _params(Params, case)
    jnet, tnet = j_make_network(jp), make_network(tp)
    jeos, teos = j_make_eos(jp, jnet), make_eos(tp, tnet)
    assert isinstance(teos, {"m": MultigammaEos, "p": PolytropeEos,
                             "r": RadPowerLawEos}[case[0]])
    rng = np.random.default_rng(3)
    n = 16
    rho = 10.0 ** rng.uniform(-3, 8, n)
    T = 10.0 ** rng.uniform(3, 9, n)
    x = rng.uniform(0.0, 1.0, (tnet.nspec, n))
    x /= x.sum(0)
    ref0 = jeos.rt(rho=jnp.asarray(rho), T=jnp.asarray(T), xn=jnp.asarray(x))
    e, p, h = (np.asarray(getattr(ref0, k)) for k in ("e", "p", "h"))
    inputs = {"rt": dict(rho=rho, T=T), "re": dict(rho=rho, e=e), "rp": dict(rho=rho, p=p),
              "tp": dict(T=T, p=p), "rh": dict(rho=rho, h=h), "ph": dict(p=p, h=h)}
    for mode in ALL_MODES:
        kw = inputs[mode]
        ref = getattr(jeos, mode)(**{k: jnp.asarray(v) for k, v in kw.items()},
                                  xn=jnp.asarray(x))
        got = getattr(teos, mode)(**{k: torch.tensor(v) for k, v in kw.items()},
                                  xn=torch.tensor(x))
        _same_state(got, ref)
    # without a composition (the multigamma falls back to the mean gamma)
    _same_state(teos.rt(rho=torch.tensor(rho), T=torch.tensor(T)),
                jeos.rt(rho=jnp.asarray(rho), T=jnp.asarray(T)))


def test_extra_keys_arrive_as_numbers():
    """`eos.species_gammas` and the rad_power_law keys from an inputs text,
    as the CLI passes them, build the same EOS as from a Params."""
    text = ("eos.eos_name = multigamma\nnetwork.network_name = general_null\n"
            "network.spec_names = X A B\neos.species_gammas = 1.666 1.4 1.3\n")
    for parse in (parse_inputs_text, j_parse):
        p = parse(text)
        assert p.extra["eos.species_gammas"] == (1.666, 1.4, 1.3)
    tp = parse_inputs_text(text)
    eos = make_eos(tp, make_network(tp))
    np.testing.assert_array_equal(eos.gammas, [1.666, 1.4, 1.3])
    rp = parse_inputs_text("eos.eos_name = rad_power_law\neos.const_c_v = 3\n"
                           "eos.c_v_exp_m = 1\neos.c_v_exp_n = 0.5\n")
    eos = make_eos(rp)
    assert (eos.const_c_v, eos.m, eos.n) == (3.0, 1.0, 0.5)
    # one gamma for every species when species_gammas is not given
    one = make_eos(Params().with_ns("eos", eos_name="multigamma", eos_gamma=1.4),
                   make_network(Params()))
    np.testing.assert_array_equal(one.gammas, [1.4])


def _zones(nspec, seed, n=6):
    rng = np.random.default_rng(seed)
    rho = 10.0 ** rng.uniform(5.0, 9.5, n)
    T = 10.0 ** rng.uniform(8.3, 9.9, n)
    x = rng.uniform(0.0, 1.0, (nspec, n))
    x[rng.uniform(size=x.shape) < 0.2] = 0.0
    x /= x.sum(0)
    return rho, T, x


@pytest.mark.parametrize("name", ["aprox21", "subch"])
@pytest.mark.parametrize("neutrinos", [True, False])
def test_rhs_matches_jax(name, neutrinos):
    from castro_tpu.network.aprox21 import Aprox21Network as JAprox21
    from castro_tpu.network.subch import SubchNetwork as JSubch

    jcls, tcls = {"aprox21": (JAprox21, Aprox21Network), "subch": (JSubch, SubchNetwork)}[name]
    jnet, tnet = jcls(include_neutrinos=neutrinos), tcls(include_neutrinos=neutrinos)
    rho, T, x = _zones(tnet.nspec, seed=11)
    jx, je = jnet.rhs(jnp.asarray(rho), jnp.asarray(T), jnp.asarray(x))
    tx, te = tnet.rhs(torch.tensor(rho), torch.tensor(T), torch.tensor(x))
    jx, je = np.asarray(jx), np.asarray(je)
    scale = np.abs(jx).max(0)
    assert np.all(np.abs(tx.numpy() - jx) <= 1e-10 * np.abs(jx) + 1e-12 * scale)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-10)
    np.testing.assert_allclose(tx.numpy().sum(0), 0.0, atol=1e-10 * scale.max())


@pytest.mark.parametrize("name,nspec", [("aprox21", 21), ("subch", 17)])
def test_make_network_builds_item7_networks(name, nspec):
    net = make_network(Params().with_ns("network", network_name=name))
    jnet = j_make_network(JParams().with_ns("network", network_name=name))
    assert net.nspec == nspec and net.reactive and net.spec_names == jnet.spec_names
    np.testing.assert_array_equal(net.aion, np.asarray(jnet.aion))
    np.testing.assert_array_equal(net.zion, np.asarray(jnet.zion))
    np.testing.assert_allclose(net.ebin, np.asarray(jnet.ebin), rtol=1e-15)


def test_model_parser_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    r = np.linspace(1e7, 1e9, 17)
    cols = {"density": 10 ** rng.uniform(0, 9, 17), "temperature": 10 ** rng.uniform(6, 9, 17),
            "pressure": 10 ** rng.uniform(10, 25, 17), "helium-4": rng.uniform(0, 1, 17)}
    path = tmp_path / "star.hse"
    with open(path, "w") as f:
        f.write(f"# npts = {r.size}\n# num of variables = {len(cols)}\n")
        for k in cols:
            f.write(f"# {k}\n")
        for i in range(r.size):
            f.write(" ".join(f"{v:.17e}" for v in [r[i]] + [c[i] for c in cols.values()]) + "\n")
    got, ref = InitialModel.from_file(str(path)), JModel.from_file(str(path))
    assert got.names == ref.names == list(cols)
    q = np.linspace(0.0, 1.2e9, 31)
    for k in cols:
        np.testing.assert_array_equal(got.data[k], cols[k])
        np.testing.assert_array_equal(got.interpolate(k, q), ref.interpolate(k, q))
    bad = tmp_path / "short.hse"
    bad.write_text("# npts = 3\n# density\n1.0 2.0\n")
    with pytest.raises(ValueError, match="expected 3 rows"):
        InitialModel.from_file(str(bad))
