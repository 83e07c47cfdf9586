"""The electron-positron table of the Helmholtz EOS (counterpart of
`castro_tpu/eos/helmholtz_table.py`).

The reference interpolates a table of the electron-positron gas over
(rho Ye, T) (Microphysics eos/helmholtz; Timmes & Swesty 2000). The port
reads its own copy of the JAX package's table, `_helm_table_cache.npz`:
log10 P_e and log10 E_e (erg/cm^3) on a log10(rho Ye) x log10(T) grid of
129 x 81 points over [-10, 11] x [3, 13], which the JAX package's numpy
generator made from relativistic Fermi-Dirac integrals with pair
production, charge neutrality solved for the degeneracy parameter.
"""

from __future__ import annotations

import os

import numpy as np

TABLE_PATH = os.path.join(os.path.dirname(__file__), "_helm_table_cache.npz")
KEY = (129, 81, -10.0, 11.0, 3.0, 13.0)  # n_d, n_t, logd_lo, logd_hi, logt_lo, logt_hi


def build_table(path=None):
    """The table {logd, logt, logp, loge}, read from `path` (default the
    port's own file)."""
    data = np.load(TABLE_PATH if path is None else path)
    if tuple(data["key"]) != KEY:
        raise ValueError(f"the Helmholtz table has axes {tuple(data['key'])}, not {KEY}")
    return dict(logd=data["logd"], logt=data["logt"], logp=data["logp"], loge=data["loge"])
