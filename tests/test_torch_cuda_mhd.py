"""MHD on the card against the CPU (`mhd/`, the MHD branches of
`driver/sim.py` and `driver/amr.py`): torch ops throughout, as the JAX
package leaves MHD to XLA, so no kernel launches (the launch counts stay
0) and the card's steps are held against the same steps on the CPU.

Marked `cuda`: each test asks the `card` fixture, which skips when no card
is present. On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_mhd.py`. Tolerance: float64 1e-8 |cpu| + 1e-8
max|cpu| per component (the state; the face fields their vector's), float32
2e-5; div B below 1e-10 on the card.
"""

import pytest
import torch

from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.mhd import MhdSimulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.stencil import interior_slice
from castro_tpu_torch.problems import mhd_tests as mt
from castro_tpu_torch.problems import orszag_tang as ot

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, ref, rtol, vector=False):
    """rtol |cpu| + rtol max|cpu| per leading component (with `vector`, the
    largest over the components: the face fields)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().flatten(1).amax(1).reshape((-1,) + (1,) * (ref.dim() - 1))
    if vector:
        scale = scale.max()
    assert bool(((got - ref).abs() <= rtol * ref.abs() + rtol * scale).all()), \
        float((got - ref).abs().max())


def _steps(make, device, steps, dt):
    s_ = make(device)
    s_.init_data()
    for _ in range(steps):
        s_.advance(dt)
    return s_


@pytest.mark.parametrize("ctu", [1, 0], ids=["ctu", "rk2"])
def test_alfven_3d_card_vs_cpu(card, ctu):
    def make(device):
        return Simulation(mt.alfven_params(n=12).with_ns("castro", mhd_ctu=ctu),
                          problem_init=mt.alfven_init, device=device)

    ref = _steps(make, "cpu", 0, 0.0)
    dt = ref.estimate_dt()
    K.reset_launch_counts()
    got = _steps(make, None, 2, dt)
    assert got.device.type == "cuda" and not any(K.launch_counts().values())
    ref = _steps(make, "cpu", 2, dt)
    _close(got.interior(), ref.interior(), 1e-8)
    _close(torch.stack(got.u_b), torch.stack(ref.u_b), 1e-8, vector=True)
    div = got.mhd.div_b(got.u_b)[interior_slice(got.ng, 3, 0)]
    assert float(div.abs().max()) < 1e-10


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-8), ("float32", 2e-5)])
def test_orszag_tang_card_vs_cpu(card, dtype, rtol):
    def make(device):
        return MhdSimulation(ot.make_params(n=32, dtype=dtype), problem_init=ot.problem_init,
                             device=device)

    ref = make("cpu")
    ref.init_data()
    dt = 0.5 * ref.estdt()
    out = {}
    for device in ("cpu", "cuda"):
        m_ = make(device)
        m_.init_data()
        for _ in range(2):
            m_.state = m_.step(m_.state, dt)
        out[device] = m_
    _close(out["cuda"].interior(), out["cpu"].interior(), rtol)
    _close(torch.stack(out["cuda"].state.b), torch.stack(out["cpu"].state.b), rtol, vector=True)


def test_two_level_orszag_tang_card_vs_cpu(card):
    def tag(sim, u_int, level):
        x, y = sim.geom.cell_centers(0, 0), sim.geom.cell_centers(1, 0)
        return ((x > 0.3) & (x < 0.7) & (y > 0.3) & (y < 0.7)).expand(u_int.shape[1:])

    def make(device):
        p = ot.make_params(n=32).with_ns("amr", max_level=1, regrid_int=0, n_error_buf=2)
        return AmrSimulation(p, problem_init=ot.problem_init, problem_tagging=tag, device=device)

    ref0 = make("cpu")
    ref0.init_data()
    dt = ref0.estimate_dt()
    got = _steps(make, None, 2, dt)
    ref = _steps(make, "cpu", 2, dt)
    for l in range(2):
        assert torch.equal(got.masks[l].cpu(), ref.masks[l])
        _close(got.interior(l), ref.interior(l), 1e-8)
        _close(torch.stack(got.u_b[l]), torch.stack(ref.u_b[l]), 1e-8, vector=True)
