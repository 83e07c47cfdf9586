"""The JAX package's physical checks of the hydro test setups
(tests/test_hydro_problems.py, its 7 tests, and
tests/test_problem_coverage.py:57-77), run on the PyTorch port on the CPU
with the same sizes, steps and bounds.
"""

import numpy as np
import pytest
import torch

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import hydro_tests as ht
from castro_tpu_torch.problems import riemann_2d


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _advance(sim, nsteps, dt=None, frac=0.5):
    """nsteps steps of sim's step from sim.u, each at dt or at `frac` of
    the CFL estimate of its state (tests/test_hydro_problems.py:_advance,
    tests/test_problem_coverage.py:_run)."""
    u, t = sim.u, 0.0
    for _ in range(nsteps):
        d = dt if dt is not None else float(sim._estdt_impl(u)) * frac
        u, _, bad = sim._step_impl(u, d, t)[:3]
        t += d
        assert not bool(bad)
    return u


def _sim(params, init):
    sim = Simulation(params, problem_init=init, device="cpu")
    sim.init_data()
    return sim


def test_noh_postshock_density_1d_spherical():
    """1D spherical Noh: the stagnated density plateaus at the exact
    ((g+1)/(g-1))^3 = 64 for gamma = 5/3 (shock at r = t/3)."""
    n = 256
    sim = _sim(ht.noh_params(n=n, dim=1, coord=2), ht.noh_init)
    u, t, dt = sim.u, 0.0, 5e-4
    for _ in range(600):
        u, _, bad = sim._step_impl(u, dt, t)
        t += dt
        assert not bool(bad)
    rho = sim.interior(u).numpy()[sim.layout.URHO]
    exact = ht.noh_postshock_density(5.0 / 3.0, dim=3)
    r = (np.arange(n) + 0.5) / n
    sel = (r < 0.8 * t / 3.0) & (r > 4.0 / n)
    assert sel.sum() > 10
    core = float(np.median(rho[sel]))
    assert abs(core - exact) / exact < 0.1, (core, exact)


def test_noh_2d_smoke():
    """2D Cartesian-octant Noh stays finite and forms the stagnation shock."""
    sim = _sim(ht.noh_params(n=48, dim=2), ht.noh_init)
    u = _advance(sim, 60, dt=2e-3)
    rho = sim.interior(u).numpy()[sim.layout.URHO]
    assert np.isfinite(rho).all()
    assert rho.max() > 8.0


def test_gresho_vortex_stationary():
    """The Gresho vortex is a steady state: after 40 steps its kinetic
    energy and velocity field are kept."""
    sim = _sim(ht.gresho_params(n=64), ht.gresho_init)
    L = sim.layout
    u0 = sim.interior().numpy()
    u1 = sim.interior(_advance(sim, 40, dt=2e-3)).numpy()
    ke0 = 0.5 * ((u0[L.UMX] ** 2 + u0[L.UMY] ** 2) / u0[L.URHO]).sum()
    ke1 = 0.5 * ((u1[L.UMX] ** 2 + u1[L.UMY] ** 2) / u1[L.URHO]).sum()
    assert ke1 > 0.85 * ke0, (ke0, ke1)
    c = np.corrcoef(u0[L.UMX].ravel(), u1[L.UMX].ravel())[0, 1]
    assert c > 0.99, c


def test_kh_grows():
    sim = _sim(ht.kh_params(n=48), ht.kh_init)
    ui = sim.interior(_advance(sim, 40)).numpy()
    assert np.isfinite(ui).all()
    # transverse kinetic energy from the seed
    assert (ui[sim.layout.UMY] ** 2 / ui[sim.layout.URHO]).sum() > 0.0


def test_rt_sinks():
    sim = _sim(ht.rt_params(n=(32, 64)), ht.rt_init)
    ui = sim.interior(_advance(sim, 30)).numpy()
    assert np.isfinite(ui).all()
    # gravity accelerates the interface: vertical momentum appears
    assert np.abs(ui[sim.layout.UMY]).max() > 1e-3


def test_oddeven_hybrid_riemann_stable():
    """A strong grid-aligned shock with a seeded odd-even perturbation:
    with hybrid_riemann=1 the flow stays finite and the colliding flows
    build a dense central slab."""
    sim = _sim(ht.oddeven_params(n=48), ht.oddeven_init)
    assert sim.cfg.hybrid_riemann
    ui = sim.interior(_advance(sim, 30, frac=0.4)).numpy()
    assert np.isfinite(ui).all()
    assert ui[sim.layout.URHO].max() > 3.0


def test_lw_acoustics_vortex_pair_corotation():
    """Vortices_LWAcoustics (Lee & Koo 1995): the co-rotating vortex pair,
    rescaled (r_0 = 5, ratio_c = 0.3) so that 96^2 resolves it, spins
    clockwise about its centroid at omega = circ / (4 pi r_0^2) within half
    of it after 60 steps."""
    n = 96
    r_0, ratio_c, r_circ = 5.0, 0.3, 2.0
    sim = _sim(ht.lw_acoustics_params(n=n, r_0=r_0, ratio_c=ratio_c, r_circ=r_circ),
               ht.lw_acoustics_init)
    L = sim.layout
    dx = sim.geom.dx[0]
    xc = 0.5 * sim.params.geometry.prob_hi[0]

    def vortex_angle(u):
        q = sim.interior(u).numpy()
        vx = q[L.UMX] / q[L.URHO]
        vy = q[L.UMY] / q[L.URHO]
        wz = np.gradient(vy, dx, axis=0) - np.gradient(vx, dx, axis=1)
        core = wz < 0.5 * wz.min()  # clockwise cores: wz < 0
        xi = (np.arange(n) + 0.5) * dx
        X, Y = np.meshgrid(xi, xi, indexing="ij")
        w = -wz * (core & (Y > xc))  # the upper vortex of the pair
        return np.arctan2((Y * w).sum() / w.sum() - xc, (X * w).sum() / w.sum() - xc)

    th0 = vortex_angle(sim.u)
    u, t = sim.u, 0.0
    for _ in range(60):
        d = float(sim._estdt_impl(u)) * 0.5
        u, _, bad = sim._step_impl(u, d, t)
        t += d
        assert not bool(bad)
    dth = (vortex_angle(u) - th0 + np.pi) % (2.0 * np.pi) - np.pi
    gamma, p_ref = 1.4, ht.LWA_DEFAULTS["p_ref"]
    c0 = np.sqrt(gamma * p_ref / p_ref ** (1.0 / gamma))
    omega = r_circ * r_0 * c0 / (4.0 * np.pi * r_0 ** 2)
    expected = -omega * t
    assert dth < -0.05, (dth, expected)
    assert abs(dth - expected) < 0.5 * abs(expected), (dth, expected)


def test_riemann_2d_config3():
    """60 steps at 64^2 (tests/test_problem_coverage.py:57-67): the c3
    quadrant interaction drives the density above 1.5 near the centre."""
    sim = _sim(riemann_2d.make_params(n=64, config=3), riemann_2d.problem_init)
    ui = sim.interior(_advance(sim, 60)).numpy()
    assert np.isfinite(ui).all()
    assert ui[sim.layout.URHO].max() > 1.5


@pytest.mark.parametrize("config", sorted(riemann_2d.CONFIGS))
def test_riemann_2d_config_init(config):
    sim = _sim(riemann_2d.make_params(n=16, config=config), riemann_2d.problem_init)
    assert bool(torch.isfinite(sim.u).all())
