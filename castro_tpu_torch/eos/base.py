"""EOS interface: functional, vectorized, mode-dispatched.

Counterpart of `castro_tpu/eos/base.py`. Each input mode is a method
returning a fresh `EosState` of tensors. Species mass fractions `xn` are
component-major: `xn[nspec, *grid]`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class EosState(NamedTuple):
    """Thermodynamic state bundle (Microphysics `eos_t`)."""

    rho: torch.Tensor
    T: torch.Tensor
    p: torch.Tensor
    e: torch.Tensor
    h: torch.Tensor
    gam1: torch.Tensor  # first adiabatic index Gamma_1
    cs: torch.Tensor  # adiabatic sound speed
    dpdr_e: torch.Tensor  # (dp/drho)|e
    dpde: torch.Tensor  # (dp/de)|rho
    dpdT: torch.Tensor
    dedT: torch.Tensor
    cv: torch.Tensor
    cp: torch.Tensor
    mu: torch.Tensor  # mean molecular weight
    abar: torch.Tensor
    zbar: torch.Tensor


class Eos:
    """Base EOS. Subclasses implement the (rho,T)->state core and inversions."""

    uses_composition: bool = True

    #: pure-arithmetic EOS (no table gathers or iteration): the CUDA kernels
    #: evaluate it in-kernel, so this gates the kernel path of a step
    pallas_safe: bool = False

    def mu_from_xn(self, xn: Optional[torch.Tensor]):
        raise NotImplementedError

    def rt(self, rho, T, xn=None) -> EosState:
        raise NotImplementedError

    def re(self, rho, e, xn=None) -> EosState:
        raise NotImplementedError

    def rp(self, rho, p, xn=None) -> EosState:
        raise NotImplementedError

    def rh(self, rho, h, xn=None) -> EosState:
        raise NotImplementedError

    def tp(self, T, p, xn=None) -> EosState:
        raise NotImplementedError

    def ph(self, p, h, xn=None) -> EosState:
        raise NotImplementedError

    def __call__(self, mode: str, **kw) -> EosState:
        return getattr(self, mode)(**kw)
