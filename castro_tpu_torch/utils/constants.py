"""Fundamental constants, CGS (matches Microphysics `fundamental_constants.H`).

The subset of `castro_tpu/utils/constants.py` that the gamma-law EOS reads."""

k_B = 1.380649e-16  # erg/K
m_u = 1.66053906660e-24  # g (atomic mass unit)
