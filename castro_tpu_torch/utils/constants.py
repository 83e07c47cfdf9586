"""Fundamental constants, CGS (matches Microphysics `fundamental_constants.H`).

The subset of `castro_tpu/utils/constants.py` that the EOSes and the
reaction networks, gravity, radiation and the problem setups read."""

Gconst = 6.67430e-8  # cm^3/g/s^2
k_B = 1.380649e-16  # erg/K
m_u = 1.66053906660e-24  # g (atomic mass unit)
N_A = 6.02214076e23  # 1/mol
c_light = 2.99792458e10  # cm/s
sigma_SB = 5.670374419e-5  # erg/cm^2/s/K^4
a_rad = 4.0 * sigma_SB / c_light  # radiation constant, erg/cm^3/K^4
q_e = 4.80320425e-10  # esu
MeV2erg = 1.602176634e-6
hplanck = 6.62607015e-27  # erg s
m_e = 9.1093837015e-28  # g (electron mass)
ev2erg = 1.602176634e-12  # erg/eV
M_solar = 1.98848e33  # g
