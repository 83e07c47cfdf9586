"""subch burned through `StrangReactor.react` with the Helmholtz EOS, in
the port against the JAX package on the CPU, float64: four zones of a He
shell's mix (He4, C12, O16, N14 and the catalytic H1), the check of
test_torch_burn_aprox21.py (`react_case`).
"""

import pytest
import torch

from test_torch_burn_aprox21 import react_case


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_react_matches_jax():
    react_case("subch")
