"""MHD on two-level AMR: a regrid and a uniform field (the helpers and
tolerances of tests/test_torch_mhd_amr.py). The regrid moves the window
onto new gradient tags (tests/test_mhd_amr.py's magg indicator): the new
window's migrated state, its face field re-prolonged from the coarse level
and the masks as the JAX package's, div B = 0 on both levels. A uniform
flow in a uniform oblique field stays uniform through the hierarchy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import orszag_tang as jot

from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.problems import orszag_tang as tot
from castro_tpu_torch.problems.util import fill_from_prim

from test_torch_mhd_amr import _jinit, _params, _ttag, check_levels, divb_max
from test_torch_radiation import _few_threads  # noqa: F401


def test_regrid_migrates_the_window():
    """A regrid on gradient tags (tests/test_mhd_amr.py's magg indicator):
    the new window's state and re-prolonged face field as the JAX
    package's, div B = 0 on both levels."""
    kw = dict(refinement_indicators=("magg",))
    extra = {"amr.magg.field": "density", "amr.magg.relative_gradient": 0.05}
    ja = JAmr(_params(jot, **kw).replace(extra=extra), problem_init=_jinit)
    ta = AmrSimulation(_params(tot, **kw).replace(extra=extra), problem_init=tot.problem_init,
                       device="cpu")
    with jax.disable_jit():
        ja.init_data()
        ta.init_data()
        # move the tags: a density bump off centre
        for a, xp in ((ja, jnp), (ta, torch)):
            L = a.sim0.layout
            ui = a.u[0]
            bump = 0.5 * xp.exp(-((a.sim0.geom.cell_centers(0, a.ng) - 0.25) ** 2
                                  + (a.sim0.geom.cell_centers(1, a.ng) - 0.7) ** 2) / 0.005)
            if xp is torch:
                ui = ui.clone()
                ui[L.URHO] = ui[L.URHO] * (1.0 + bump)
            else:
                ui = ui.at[L.URHO].multiply(1.0 + bump)
            a.u[0] = ui
        win0 = (tuple(ta.window[1][0]), tuple(ta.window[1][1]))
        ja.regrid()
        ta.regrid()
    assert (tuple(ta.window[1][0]), tuple(ta.window[1][1])) != win0
    check_levels(ta, ja)


def test_uniform_field_preserved():
    """Uniform flow in a uniform oblique field through the static box
    stays uniform (the fillpatch, the reflux and the CT register are
    identities on constants); div B = 0 on both levels."""
    def init(sim, u, b):
        u = fill_from_prim(sim, u, 1.0, (1.0, 0.5, 0.0), p=1.0)
        shape = tuple(u.shape[1:])
        return u, tuple(torch.full(shape, v, dtype=u.dtype) for v in (0.3, -0.2, 0.1))

    amr = AmrSimulation(_params(tot, n=16), problem_init=init, problem_tagging=_ttag,
                        device="cpu")
    amr.init_data()
    for _ in range(3):
        amr.advance(5e-3)
    u0 = amr.interior(0).numpy()
    assert np.allclose(u0[0], 1.0, rtol=1e-6)
    for d, v in enumerate((0.3, -0.2, 0.1)):
        for l in range(2):
            assert np.allclose(amr.u_b[l][d].numpy(), v, atol=1e-6), (l, d)
    assert divb_max(amr, 0) < 1e-10 and divb_max(amr, 1) < 1e-10
