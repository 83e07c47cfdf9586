"""Reaction networks (counterpart of `castro_tpu/network/__init__.py`;
reference Microphysics networks, chosen per problem with `NETWORK_DIR`).

A Network owns species metadata (names, A, Z, binding energies) and, for
reactive networks, a vectorized RHS f(rho, T, X) -> (dX/dt, de/dt) over
whole arrays at once. general_null, powerlaw, iso7, aprox13, aprox19,
aprox21, triple_alpha_plus_cago, rprox, nova and subch; the NSE solver of
`network.nse=1` is `nse.py`."""

from __future__ import annotations

from castro_tpu_torch.network.base import Network
from castro_tpu_torch.network.general_null import GeneralNullNetwork
from castro_tpu_torch.network.powerlaw import PowerLawNetwork

__all__ = ["Network", "GeneralNullNetwork", "PowerLawNetwork", "make_network"]


def make_network(params) -> Network:
    name = params.network.network_name
    if name in ("general_null", "null"):
        return GeneralNullNetwork(spec_names=params.network.spec_names or ("X",),
                                  aux_names=params.network.aux_names)
    if name == "powerlaw":
        n = params.network
        return PowerLawNetwork(rtilde=n.rtilde, nu=n.nu, specific_q_burn=n.specific_q_burn,
                               T_burn_ref=n.T_burn_ref, rho_burn_ref=n.rho_burn_ref,
                               f_act=n.f_act)
    if name == "aprox13":
        from castro_tpu_torch.network.aprox13 import Aprox13Network

        return Aprox13Network()
    if name == "iso7":
        from castro_tpu_torch.network.iso7 import Iso7Network

        return Iso7Network()
    if name == "aprox19":
        from castro_tpu_torch.network.aprox19 import Aprox19Network

        return Aprox19Network()
    if name in ("triple_alpha_plus_cago", "triple_alpha"):
        from castro_tpu_torch.network.triple_alpha import TripleAlphaCagoNetwork

        return TripleAlphaCagoNetwork()
    if name == "rprox":
        from castro_tpu_torch.network.rprox import RproxNetwork

        return RproxNetwork()
    if name == "nova":
        from castro_tpu_torch.network.nova import NovaNetwork

        return NovaNetwork()
    if name == "aprox21":
        from castro_tpu_torch.network.aprox21 import Aprox21Network

        return Aprox21Network()
    if name == "subch":
        from castro_tpu_torch.network.subch import SubchNetwork

        return SubchNetwork()
    raise ValueError(f"unknown network '{name}'")
