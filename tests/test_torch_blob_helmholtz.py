"""The 3D burning blob with the Helmholtz EOS against the JAX package (the
set-up and tolerance of test_torch_blob.py). prim_aux and clean_fill take
the torch ops here, as the JAX package takes XLA for an EOS its kernels
cannot evaluate; the face kernels' structure still runs (plain versions on
the CPU)."""

import pytest
import torch

from test_torch_blob import blob_matches_jax


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_blob_helmholtz_matches_jax():
    sim, moved = blob_matches_jax("helmholtz", steps=1)
    assert not sim._kernel_prim and not sim._kernel_clean_fill and sim.cfg.use_kernels
    assert moved > 0
