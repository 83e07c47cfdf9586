"""The burner's loop (castro_tpu_torch/integrators/stiff.py), as the card
runs it, held on the CPU: `lu_factor_ops` against torch.linalg.lu_factor,
pivots included; the masked iteration (every zone stepped, the step kept
where the zone is active) against a loop that gathers the active zones
and steps only those, on aprox19 + Helmholtz zones from an iron core in
NSE to a cold one, with a cap that the core reaches: the state, the
failure flags, each zone's steps and the loop's iterations; and the
burner against the JAX package's at the same cap, within 1e-8 (mass
fractions absolute, energy relative), the failure flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.eos.helmholtz import HelmholtzEos as JHelm
from castro_tpu.integrators.stiff import make_burner as j_make_burner
from castro_tpu.network.aprox19 import Aprox19Network as JAprox19
from castro_tpu_torch.eos.helmholtz import HelmholtzEos
from castro_tpu_torch.integrators import stiff
from castro_tpu_torch.integrators.stiff import lu_factor_ops, make_burner
from castro_tpu_torch.network.aprox19 import Aprox19Network
from test_torch_cuda_science import burn_zones as _zones

jax.config.update("jax_enable_x64", True)

KW = dict(rtol=1e-6, atol_x=1e-8, atol_e=1e-6)
CAP = 12  # max_substeps: the iron core's zone needs more
DT = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_lu_factor_ops_matches_linalg():
    rng = np.random.default_rng(3)
    W = rng.standard_normal((6, 20, 20))
    W[1, 0, 0] = 0.0                    # the first pivot must be found below
    W[2] = np.eye(20) - 0.1 * rng.standard_normal((20, 20))  # as I - h D J
    W[3, :, 5] *= 1e-12                 # a column many orders smaller
    W[4] = np.triu(W[4]) + 10 * np.eye(20)  # no exchange at all
    W[5] = W[5][::-1]
    Wt = torch.tensor(W)
    lu, piv = lu_factor_ops(Wt)
    lu_ref, piv_ref = torch.linalg.lu_factor(Wt)
    assert piv.dtype == piv_ref.dtype
    assert torch.equal(piv, piv_ref)
    scale = Wt.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((lu - lu_ref).abs() / scale).max()) < 1e-12
    b = torch.tensor(rng.standard_normal((6, 20, 1)))
    x = torch.linalg.lu_solve(lu, piv, b)
    resid = (Wt @ x - b).abs().amax(dim=(1, 2)) / (scale[:, 0, 0] * x.abs().amax(dim=(1, 2)))
    assert float(resid.max()) < 1e-13


def _gathered(burn, nspec, rho, y, dt):
    """The loop over the active zones only: each iteration gathers the
    zones with t < t_done and steps those (one Rosenbrock step of the same
    burner); returns (y, t, steps, iterations)."""
    t_done = dt * (1.0 - 100.0 * float(torch.finfo(y.dtype).eps))
    t = torch.zeros_like(rho)
    h = torch.full_like(t, dt / 16.0)
    steps = torch.zeros(rho.shape, dtype=torch.int32)
    it = 0
    while it < CAP:
        idx = torch.nonzero(t < t_done).flatten()
        if idx.numel() == 0:
            break
        ya, ta, ha = y[idx], t[idx], h[idx]
        h_eff = torch.minimum(ha, dt - ta)
        y_new, err = burn.rosenbrock_step(ya, rho[idx], h_eff)
        scale = KW["atol_x"] + KW["rtol"] * torch.maximum(ya.abs(), y_new.abs())
        scale[:, nspec] = KW["atol_e"] + KW["rtol"] * torch.maximum(ya[:, nspec].abs(),
                                                                   y_new[:, nspec].abs())
        enorm = torch.amax(err.abs() / scale, dim=1)
        ok = (enorm <= 1.0) & torch.all(torch.isfinite(y_new), dim=1)
        y[idx] = torch.where(ok[:, None], y_new, ya)
        t[idx] = torch.where(ok, ta + h_eff, ta)
        fac = stiff.SAFETY * torch.where(enorm > 0, enorm ** (-1.0 / 3.0),
                                         torch.full_like(enorm, stiff.GROW_MAX))
        fac = fac.clamp(stiff.SHRINK_MIN, stiff.GROW_MAX)
        fac = torch.where(torch.isfinite(enorm), fac, torch.full_like(fac, stiff.SHRINK_MIN))
        h[idx] = h_eff * fac
        steps[idx] += 1
        it += 1
    return y, t, steps, it


@pytest.fixture(scope="module")
def port_burn():
    net = Aprox19Network()
    eos = HelmholtzEos(network=net)
    rho, T, x = _zones(net)
    e = eos.rt(rho=torch.tensor(rho), T=torch.tensor(T), xn=torch.tensor(x)).e.numpy()
    burn = make_burner(net, eos, max_substeps=CAP, **KW)
    args = tuple(torch.tensor(a) for a in (rho, T, x, e))
    xn, en, fail = burn(*args, DT)
    return net, burn, (rho, T, x, e), (xn, en, fail), burn.stats


def test_masked_loop_matches_gathered(port_burn):
    net, burn, (rho, T, x, e), (xn, en, fail), stats = port_burn
    nspec = net.nspec
    y0 = torch.tensor(np.concatenate([x, e[None]], axis=0).T.copy())
    y, t, steps, it = _gathered(burn, nspec, torch.tensor(rho), y0, DT)
    t_done = DT * (1.0 - 100.0 * float(torch.finfo(torch.float64).eps))
    x_ref = y[:, :nspec].T.clamp(0.0, 1.0)
    x_ref = x_ref / x_ref.sum(0).clamp_min(1e-30)
    np.testing.assert_allclose(xn.numpy(), x_ref.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(en.numpy(), y[:, nspec].numpy(), rtol=1e-12)
    assert fail.tolist() == (t < t_done).tolist()
    assert stats.zone_steps.tolist() == steps.tolist()
    assert stats.iterations == it == CAP
    # the core hits the cap; the cold zone finishes in the fewest steps
    assert fail.tolist()[0] and not fail.tolist()[-1]
    assert steps.tolist()[0] == CAP and steps.tolist()[-1] < CAP


def test_masked_burn_matches_jax_at_the_cap(port_burn):
    net, burn, (rho, T, x, e), (xn, en, fail), _ = port_burn
    jnet = JAprox19()
    jeos = JHelm(network=jnet)
    jxn, jen, jfail = j_make_burner(jnet, jeos, max_substeps=CAP, **KW)(
        *(jnp.asarray(a) for a in (rho, T, x, e)), DT)
    np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=0, atol=1e-8)
    np.testing.assert_allclose(en.numpy(), np.asarray(jen), rtol=1e-8)
    assert fail.tolist() == np.asarray(jfail).tolist()
