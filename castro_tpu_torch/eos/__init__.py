"""Equation-of-state factory (counterpart of `castro_tpu/eos/__init__.py`).

The gamma law, the polytrope, multigamma, rad_power_law and Helmholtz."""

from __future__ import annotations

from castro_tpu_torch.eos.base import Eos, EosState
from castro_tpu_torch.eos.gamma_law import GammaLawEos
from castro_tpu_torch.eos.multigamma import MultigammaEos
from castro_tpu_torch.eos.polytrope import PolytropeEos
from castro_tpu_torch.eos.rad_power_law import RadPowerLawEos

__all__ = ["Eos", "EosState", "GammaLawEos", "MultigammaEos", "PolytropeEos",
           "RadPowerLawEos", "make_eos"]


def make_eos(params, network=None) -> Eos:
    name = params.eos.eos_name
    if name == "gamma_law":
        return GammaLawEos(gamma=params.eos.eos_gamma, network=network,
                           assume_neutral=bool(params.eos.eos_assume_neutral))
    if name == "polytrope":
        e = params.eos
        return PolytropeEos(K=e.polytrope_K, gamma=e.polytrope_gamma, mu_e=e.polytrope_mu_e,
                            polytrope_type=e.polytrope_type, network=network)
    if name == "multigamma":
        gammas = params.extra.get("eos.species_gammas", None)
        if gammas is None:
            gammas = [params.eos.eos_gamma] * (network.nspec if network else 1)
        return MultigammaEos(gammas=gammas, network=network)
    if name == "rad_power_law":
        x = params.extra
        return RadPowerLawEos(gamma=params.eos.eos_gamma,
                              const_c_v=float(x.get("eos.const_c_v", 1.0)),
                              c_v_exp_m=float(x.get("eos.c_v_exp_m", 0.0)),
                              c_v_exp_n=float(x.get("eos.c_v_exp_n", 0.0)),
                              network=network)
    if name == "helmholtz":
        from castro_tpu_torch.eos.helmholtz import HelmholtzEos

        return HelmholtzEos(network=network,
                            use_coulomb=bool(params.extra.get("eos.use_coulomb", 1)))
    raise ValueError(f"unknown EOS '{name}'")
