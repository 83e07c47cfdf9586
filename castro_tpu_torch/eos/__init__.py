"""Equation-of-state factory (counterpart of `castro_tpu/eos/__init__.py`).

Ported: the gamma law and Helmholtz; the others are ROADMAP.md queue 1
item 7."""

from __future__ import annotations

from castro_tpu_torch.eos.base import Eos, EosState
from castro_tpu_torch.eos.gamma_law import GammaLawEos

__all__ = ["Eos", "EosState", "GammaLawEos", "make_eos"]


def make_eos(params, network=None) -> Eos:
    name = params.eos.eos_name
    if name == "gamma_law":
        return GammaLawEos(gamma=params.eos.eos_gamma, network=network,
                           assume_neutral=bool(params.eos.eos_assume_neutral))
    if name == "helmholtz":
        from castro_tpu_torch.eos.helmholtz import HelmholtzEos

        return HelmholtzEos(network=network,
                            use_coulomb=bool(params.extra.get("eos.use_coulomb", 1)))
    raise NotImplementedError(
        f"EOS {name!r} is not ported (ROADMAP.md, queue 1 item 7)")
