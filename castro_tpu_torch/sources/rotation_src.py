"""Rotating-frame sources (counterpart of `castro_tpu/sources/rotation_src.py`;
reference `Source/rotation/`).

- `accel`, the reference's rotational_acceleration (Rotation.H:38): in the
  rotating frame the Coriolis term -2 Omega x v and the centrifugal term
  -Omega x (Omega x r); with castro.state_in_rotating_frame=0 the
  inertial-frame form -Omega x v (Byerly et al. 2014, Eqs. 16-17).
- The old-time source: momentum rho a, energy v . rho a.
- The new-time `corrector`: with castro.implicit_rotation_update=1 the
  coupled implicit momentum update of Katz et al. 2016 (the dt-omega
  matrix of rotation_sources.cpp:225-260, stable for any Omega dt);
  energy by castro.rot_source_type 1-4, type 4 in its cell-centred form
  (-drho phi_rot, the baseline the reference's flux form generalizes).

The axis is castro.rot_axis (1-based); the rotation centre is the middle
of the domain the geometry spans."""

from __future__ import annotations

import math

import torch


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


class RotationSource:
    name = "rot"

    def __init__(self, params, geom, layout, ng):
        self.c = params.castro
        self.geom = geom
        self.layout = layout
        self.ng = ng
        period = self.c.rotational_period
        self.omega_mag = 2.0 * math.pi / period if period > 0 else 0.0
        self.axis = self.c.rot_axis - 1
        self.rotating_frame = bool(self.c.state_in_rotating_frame)

    def _omega(self):
        w = [0.0, 0.0, 0.0]
        w[self.axis] = self.omega_mag
        return w

    def _coords(self, like, geom=None):
        """Cell-centre positions relative to the centre, three tensors of
        like's shape (zeros along the axes the grid lacks)."""
        geom = geom if geom is not None else self.geom
        xs = []
        for d in range(3):
            if d < geom.dim:
                center = 0.5 * (geom.prob_lo[d] + geom.prob_hi[d])
                x = geom.cell_centers(d, self.ng).to(like.dtype) - center
                xs.append(x.expand(like.shape))
            else:
                xs.append(torch.zeros_like(like))
        return xs

    def accel(self, x, v, coriolis=True):
        """The rotational acceleration of the frame (Rotation.H:38)."""
        w = self._omega()
        acc = [0.0, 0.0, 0.0]
        if self.rotating_frame:
            if self.c.rotation_include_centrifugal:
                cent = _cross(w, _cross(w, x))
                acc = [a - cc for a, cc in zip(acc, cent)]
            if self.c.rotation_include_coriolis and coriolis:
                cor = _cross(w, v)
                acc = [a - 2.0 * cv for a, cv in zip(acc, cor)]
        elif self.c.rotation_include_coriolis and coriolis:
            cor = _cross(w, v)
            acc = [a - cv for a, cv in zip(acc, cor)]
        return acc

    def potential(self, x):
        """phi_rot = -1/2 |Omega x r|^2 in the rotating frame with the
        centrifugal term (Rotation.H rotational_potential), else zero."""
        if not (self.rotating_frame and self.c.rotation_include_centrifugal):
            return torch.zeros_like(x[0])
        wxr = _cross(self._omega(), x)
        return -0.5 * sum(c * c for c in wxr)

    def __call__(self, sim, u, q, qaux, t, dt, ctx=None):
        L = self.layout
        UM = (L.UMX, L.UMY, L.UMZ)
        rho = u[L.URHO]
        v = [u[UM[d]] / rho for d in range(3)]
        x = self._coords(rho, ctx.geom if ctx is not None else None)
        acc = self.accel(x, v)
        src = torch.zeros_like(u)
        e_src = 0.0
        for d in range(3):
            Sr = rho * acc[d]
            src[UM[d]] = Sr
            e_src = e_src + v[d] * Sr
        src[L.UEDEN] = e_src
        return src

    def corrector(self, sim, u_old, u_new, t, dt, ctx=None, fluxes=None):
        """The new-time correction (rotation_sources.cpp corrsrc): src such
        that u_new + dt src completes the time centring; with
        implicit_rotation_update the Coriolis part of the new-time term is
        solved implicitly through the dt-omega matrix."""
        L = self.layout
        UM = (L.UMX, L.UMY, L.UMZ)
        rho_o = u_old[L.URHO]
        rho_n = u_new[L.URHO]
        x = self._coords(rho_o, ctx.geom if ctx is not None else None)

        v_old = [u_old[c] / rho_o for c in UM]
        Sr_old = [rho_o * a for a in self.accel(x, v_old)]
        SrE_old = sum(v * S for v, S in zip(v_old, Sr_old))
        v_new = [u_new[c] / rho_n for c in UM]
        old_ke = 0.5 * sum(u_new[c] ** 2 for c in UM) / rho_n

        if self.c.implicit_rotation_update and self.c.rotation_include_coriolis:
            # the dt-omega matrix (rotation_sources.cpp:225-260); in the
            # inertial frame the Coriolis-like term is half as large
            w = self._omega()
            fac = 1.0 if self.rotating_frame else 0.5
            dw = [fac * dt * wi for wi in w]
            den = 1.0 + dw[0] ** 2 + dw[1] ** 2 + dw[2] ** 2
            M = [[(1.0 + dw[0] * dw[0]) / den,
                  (dw[0] * dw[1] + dw[2]) / den,
                  (dw[0] * dw[2] - dw[1]) / den],
                 [(dw[1] * dw[0] - dw[2]) / den,
                  (1.0 + dw[1] * dw[1]) / den,
                  (dw[1] * dw[2] + dw[0]) / den],
                 [(dw[2] * dw[0] + dw[1]) / den,
                  (dw[2] * dw[1] - dw[0]) / den,
                  (1.0 + dw[2] * dw[2]) / den]]
            acc_nc = self.accel(x, v_new, coriolis=False)
            mom_tmp = [u_new[UM[n]] - 0.5 * dt * Sr_old[n] + 0.5 * dt * rho_n * acc_nc[n]
                       for n in range(3)]
            new_mom = [sum(M[l][m] * mom_tmp[m] for m in range(3)) for l in range(3)]
            Srcorr = [(new_mom[n] - u_new[UM[n]]) / dt for n in range(3)]
        else:
            Sr_new = [rho_n * a for a in self.accel(x, v_new)]
            Srcorr = [0.5 * (Sn - So) for Sn, So in zip(Sr_new, Sr_old)]

        src = torch.zeros_like(u_new)
        mom_corr = []
        for n in range(3):
            src[UM[n]] = Srcorr[n]
            mom_corr.append(u_new[UM[n]] + dt * Srcorr[n])

        rst = int(self.c.rot_source_type)
        if rst in (1, 2):
            vn = [m / rho_n for m in (mom_corr if rst == 2 else [u_new[c] for c in UM])]
            Sr_new = [rho_n * a for a in self.accel(x, vn)]
            SrE_new = sum(v * S for v, S in zip(vn, Sr_new))
            SrEcorr = 0.5 * (SrE_new - SrE_old)
        elif rst == 3:
            new_ke = 0.5 * sum(m * m for m in mom_corr) / rho_n
            SrEcorr = (new_ke - old_ke) / dt
        else:  # rot_source_type 4: the cell-centred potential coupling
            phi = self.potential(x)
            drho = 0.5 * (rho_n - rho_o)
            SrEcorr = -SrE_old - drho * phi / dt
        src[L.UEDEN] = SrEcorr
        return src
