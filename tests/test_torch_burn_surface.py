"""One stiff burn of rprox and of nova with the Helmholtz EOS, the port
against the JAX package on the CPU, float64 (the set-up and tolerances of
test_torch_networks_surface.py, which holds their RHS: within 1e-8, mass
fractions absolute, with equal failure flags)."""

import pytest
import torch

from test_torch_networks_surface import burn_matches_jax


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("net", ["rprox", "nova"])
def test_one_burn_matches_jax(net):
    burn_matches_jax(net)
