"""State layout: conserved / primitive / auxiliary component indices.

The reference code-generates its state layout from a table
(`Source/driver/_variables:1-66` via `set_variables.py` -> `state_indices.H`):
conserved `URHO..UFX`, primitive `QRHO..QFX`, and auxiliary `QGAMC,QC,...`
with components conditionally present per physics defines (SHOCK_VAR,
HYBRID_MOMENTUM, MHD, RADIATION, nspec/naux from the network).

Here the layout is a frozen dataclass computed at setup time; component
indices are Python ints. Arrays are component-major:
`u[NVAR, nx(+2g), ny(+2g), nz(+2g)]`, the layout of the JAX package, so
that the two packages compare index for index.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

# Number of ghost cells (reference: NUM_GROW=4, 6 for MHD;
# `Source/driver/Castro_setup.cpp:310-326`).
NUM_GROW = 4
NUM_GROW_SRC = 3
NUM_GROW_MHD = 6


@dataclass(frozen=True)
class StateLayout:
    """Index layout for one physics configuration."""

    dim: int = 3
    nspec: int = 1
    naux: int = 0
    shock_var: bool = False
    hybrid_momentum: bool = False
    mhd: bool = False
    radiation: bool = False
    ngroups: int = 0

    # ---- conserved state (Castro: URHO..UFX, `_variables` [conserved]) ----
    @property
    def URHO(self):
        return 0

    @property
    def UMX(self):
        return 1

    @property
    def UMY(self):
        return 2

    @property
    def UMZ(self):
        return 3

    @property
    def UEDEN(self):
        return 4

    @property
    def UEINT(self):
        return 5

    @property
    def UTEMP(self):
        return 6

    @property
    def USHK(self):
        # shock flag variable, present only with use_shock_var
        return 7 if self.shock_var else -1

    @property
    def UMR(self):
        return (7 + (1 if self.shock_var else 0)) if self.hybrid_momentum else -1

    @property
    def UML(self):
        return self.UMR + 1 if self.hybrid_momentum else -1

    @property
    def UMP(self):
        return self.UMR + 2 if self.hybrid_momentum else -1

    @property
    def UFS(self):
        return 7 + (1 if self.shock_var else 0) + (3 if self.hybrid_momentum else 0)

    @property
    def UFX(self):
        return self.UFS + self.nspec if self.naux > 0 else -1

    @property
    def NVAR(self):
        return self.UFS + self.nspec + self.naux

    # ---- MHD face-centered magnetic fields are stored separately ----
    # (reference keeps Bx/By/Bz as distinct face StateData,
    #  `Source/driver/Castro_setup.cpp` Mag_Type_x..z)

    # ---- primitive state (Castro: QRHO..QFX, `_variables` [primitive]) ----
    @property
    def QRHO(self):
        return 0

    @property
    def QU(self):
        return 1

    @property
    def QV(self):
        return 2

    @property
    def QW(self):
        return 3

    @property
    def QGAME(self):
        # game = p/(rho e) + 1 pseudo-gamma, used by some Riemann paths
        return 4

    @property
    def QPRES(self):
        return 5

    @property
    def QREINT(self):
        return 6

    @property
    def QTEMP(self):
        return 7

    @property
    def QMAGX(self):
        return 8 if self.mhd else -1

    @property
    def QMAGY(self):
        return 9 if self.mhd else -1

    @property
    def QMAGZ(self):
        return 10 if self.mhd else -1

    @property
    def QPTOT(self):
        base = 8 + (3 if self.mhd else 0)
        return base if (self.radiation or self.mhd) else -1

    @property
    def QREITOT(self):
        return self.QPTOT + 1 if self.radiation else -1

    @property
    def QRAD(self):
        # first radiation group energy in the primitive state
        return self.QREITOT + 1 if self.radiation else -1

    @property
    def QFS(self):
        n = 8
        if self.mhd:
            n += 3  # QMAG*
        if self.mhd and not self.radiation:
            n += 1  # QPTOT
        if self.radiation:
            n += 2 + self.ngroups  # QPTOT, QREITOT, QRAD..
        return n

    @property
    def QFX(self):
        return self.QFS + self.nspec if self.naux > 0 else -1

    @property
    def NQ(self):
        return self.QFS + self.nspec + self.naux

    # ---- auxiliary primitive quantities (Castro qaux: QGAMC, QC, QDPDR, QDPDE) ----
    @property
    def QGAMC(self):
        return 0

    @property
    def QC(self):
        return 1

    @property
    def QDPDR(self):
        return 2

    @property
    def QDPDE(self):
        return 3

    @property
    def QGAMCG(self):
        return 4 if self.radiation else -1

    @property
    def QCG(self):
        return 5 if self.radiation else -1

    @property
    def QLAMS(self):
        return 6 if self.radiation else -1

    @property
    def NQAUX(self):
        return 4 + ((2 + self.ngroups) if self.radiation else 0)

    # ---- Godunov interface state (Castro NGDNV: GDRHO,GDU..GDPRES [,GDLAMS,GDERADS]) ----
    @property
    def GDRHO(self):
        return 0

    @property
    def GDU(self):
        return 1

    @property
    def GDV(self):
        return 2

    @property
    def GDW(self):
        return 3

    @property
    def GDPRES(self):
        return 4

    @property
    def GDGAME(self):
        return 5

    @property
    def GDLAMS(self):
        return 6 if self.radiation else -1

    @property
    def GDERADS(self):
        return 6 + self.ngroups if self.radiation else -1

    @property
    def NGDNV(self):
        return 6 + (2 * self.ngroups if self.radiation else 0)

    @property
    def ngrow(self):
        return NUM_GROW_MHD if self.mhd else NUM_GROW

    # convenience: names for plotfiles / diagnostics
    @property
    def cons_names(self) -> Tuple[str, ...]:
        names = ["density", "xmom", "ymom", "zmom", "rho_E", "rho_e", "Temp"]
        if self.shock_var:
            names.append("Shock")
        if self.hybrid_momentum:
            names += ["rmom", "lmom", "pmom"]
        names += [f"rho_X{i}" for i in range(self.nspec)]
        names += [f"rho_aux{i}" for i in range(self.naux)]
        return tuple(names)

    def momentum_index(self, d: int) -> int:
        """Conserved momentum component for spatial direction d (0-based)."""
        return (self.UMX, self.UMY, self.UMZ)[d]

    def velocity_index(self, d: int) -> int:
        """Primitive velocity component for spatial direction d (0-based)."""
        return (self.QU, self.QV, self.QW)[d]


def layout_from_params(params) -> StateLayout:
    """Build the StateLayout implied by a Params tree."""
    c = params.castro
    return StateLayout(
        dim=params.dim,
        nspec=params.network.nspec,
        naux=len(params.network.aux_names),
        shock_var=bool(c.use_shock_var),
        hybrid_momentum=bool(c.hybrid_momentum),
        mhd=bool(c.do_mhd),
        radiation=bool(c.do_radiation),
        ngroups=params.radiation.ngroups if c.do_radiation else 0,
    )
