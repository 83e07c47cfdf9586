"""The multigroup radiation setups of the port against the JAX package's:
RadShestakovBolstad (64 geometric groups, its picket-fence emissivity,
kappa ~ nu^-3) at init + 2 steps (tests/test_torch_rad_setups.py:
setup_against_jax; bwp-rad in tests/test_torch_rad_setups_bwp.py);
RadSphere's multigroup field alone (`rad_sphere.run`:
60 groups, per-group Dirichlet values, the spherical metric) after a few
steps, and its analytic spectrum. Sizes cut; tolerance float64 1e-10 |jax|
+ 1e-10 max|jax| per component."""

import numpy as np

from test_torch_radiation import _few_threads, close, jit_jax_solve  # noqa: F401
from test_torch_rad_setups import setup_against_jax


def test_rad_shestakov(jit_jax_solve):
    from castro_tpu.problems import rad_shestakov as jm
    from castro_tpu_torch.problems import rad_shestakov as tm

    setup_against_jax(jm.make_params(n=32), tm.make_params(n=32), jm.problem_init,
                      tm.problem_init, jpost=jm.setup_radiation, tpost=tm.setup_radiation,
                      dt=4.5339149910673475e-08)


def test_rad_sphere(jit_jax_solve):
    from castro_tpu.problems import rad_sphere as jm
    from castro_tpu_torch.problems import rad_sphere as tm

    for a, b in zip(tm.groups(), jm.groups()):
        np.testing.assert_array_equal(a, b)
    r = np.linspace(0.03, 0.1, 5)
    for r_ in r:
        np.testing.assert_array_equal(tm.analytic_spectrum(r_, 1e-12),
                                      jm.analytic_spectrum(r_, 1e-12))
    got = tm.run(n=32, t_end=3 * 2.0e-15, dt=2.0e-15, device="cpu")
    ref = jm.run(n=32, t_end=3 * 2.0e-15, dt=2.0e-15)
    close(got[0], ref[0], what="r")
    close(got[1], ref[1], what="Er")
    # each group solve its own stop: the V-cycles differ between groups
    assert len({c_ for c_, _ in got[2].solve_stats}) > 1


def test_rad_sphere_score():
    """`rad_sphere.score` makes tests/test_rad_sphere.py's comparison: on a
    spectrum that is the analytic one, then one bright group off by 70%."""
    from castro_tpu_torch.problems import rad_sphere as tm

    r = np.linspace(0.021, 0.1, 64)
    i_obs = int(np.argmin(np.abs(r - tm.R_OBS)))
    E_ana = tm.analytic_spectrum(r[i_obs], 1e-12)
    Er = np.zeros((tm.NGROUPS, r.size))
    Er[:, i_obs] = E_ana
    exact = tm.score(r, Er, 1e-12)
    assert exact["ok"] and exact["max_rel"] == 0.0 and exact["peak_shift"] == 0
    k = int(np.argmax(E_ana))
    Er[k, i_obs] *= 1.7
    off = tm.score(r, Er, 1e-12)
    sel = E_ana > 1e-3 * E_ana.max()
    assert not off["ok"] and abs(off["max_rel"] - 0.7) < 1e-12
    assert off["median_rel"] == 0.0 and off["peak_shift"] == 0
    assert abs(off["energy_rel"] - 0.7 * E_ana[k] / E_ana.sum()) < 1e-12 and sel[k]
