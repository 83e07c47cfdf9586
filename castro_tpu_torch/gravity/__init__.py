"""Self-gravity: ConstantGrav / MonopoleGrav / PoissonGrav (counterpart of
`castro_tpu/gravity/__init__.py`).

Reference: the Gravity singleton (`Source/gravity/Gravity.cpp:110-141`
type dispatch; `solve_for_phi` :418; `get_old/new_grav_vector` :838,911;
the multipole boundary fill :1579-1743; the monopole's
`make_radial_gravity`).

The Poisson solve is the multigrid of `solvers/multigrid.py` (torch ops,
as the JAX package leaves it to XLA); the monopole is a radial scatter-add
(`index_add_`) and a gather. Every solve appends its (V-cycles, final
residual norm) to `solve_stats`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.solvers import multigrid as mg
from castro_tpu_torch.utils import constants as C


def _legendre_all(lmax, x):
    """Associated Legendre P_lm(x) for 0 <= m <= l <= lmax (no
    Condon-Shortley phase). Returns dict[(l, m)] of tensors shaped like x."""
    P = {(0, 0): torch.ones_like(x)}
    if lmax == 0:
        return P
    somx2 = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    for m in range(0, lmax + 1):
        if m > 0:
            # P_mm = (2m-1)!! somx2^m
            fact = 1.0
            for k in range(1, 2 * m, 2):
                fact *= k
            P[(m, m)] = fact * somx2 ** m
        if m + 1 <= lmax:
            P[(m + 1, m)] = x * (2 * m + 1) * P[(m, m)]
        for l in range(m + 2, lmax + 1):
            P[(l, m)] = ((2 * l - 1) * x * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def _real_sph_harm(lmax, cost, phi):
    """Real spherical harmonics Y_lm up to lmax as a list of (l, Y), with
    the (2l+1)/(4 pi) normalization, so phi = -G sum 4pi/(2l+1) q Y /
    r^(l+1)."""
    P = _legendre_all(lmax, cost)
    out = []
    for l in range(lmax + 1):
        n0 = math.sqrt((2 * l + 1) / (4.0 * math.pi))
        out.append((l, n0 * P[(l, 0)]))
        for m in range(1, l + 1):
            fac = 1.0
            for k in range(l - m + 1, l + m + 1):
                fac *= k
            nlm = math.sqrt((2 * l + 1) / (2.0 * math.pi) / fac)
            out.append((l, nlm * P[(l, m)] * torch.cos(m * phi)))
            out.append((l, nlm * P[(l, m)] * torch.sin(m * phi)))
    return out


class Gravity:
    """One object for the level, like the reference singleton."""

    def __init__(self, params, geom, layout, ng: int):
        self.params = params
        self.geom = geom
        self.layout = layout
        self.ng = ng
        self.gtype = params.gravity.gravity_type
        self.const_grav = params.gravity.const_grav
        self.periodic = all(b == 0 for b in params.castro.lo_bc[: geom.dim]) and all(
            b == 0 for b in params.castro.hi_bc[: geom.dim])
        self.n_vcycles = 50  # the cap; solves iterate to rtol
        # the MLMG rel_eps analog (Gravity.cpp:3542-3558), scaled to the
        # working precision
        self.rtol = 1e-10 if params.tpu.dtype == "float64" else 1e-5
        # ConstantGrav acts along the last spatial dimension
        self.vert = geom.dim - 1
        self.solve_stats = []

    # -- public API ---------------------------------------------------------
    def grav_vector(self, rho_interior, ctx=None):
        """g [3, interior grid] and phi (None but for PoissonGrav).

        `ctx` (the step's StepCtx) gives the window's geometry, the
        composite BCs (`grav_bc`) and the run-time point mass."""
        if self.gtype == "ConstantGrav":
            g, phi = self._constant(rho_interior)
        elif self.gtype == "MonopoleGrav":
            g, phi = self._monopole(rho_interior, ctx)
        elif self.gtype == "PoissonGrav":
            g, phi = self._poisson(rho_interior, ctx)
        else:
            raise ValueError(self.gtype)
        if self.params.castro.use_point_mass:
            # the accretion bookkeeping passes the run-time point mass
            # through ctx (Castro_pointmass.cpp:155); else the parameter
            pm = (ctx.point_mass if ctx is not None and ctx.point_mass is not None
                  else self.params.castro.point_mass)
            if not (isinstance(pm, float) and pm == 0.0):
                g = g + self._point_mass_field(rho_interior, pm, ctx.geom if ctx else None)
        return g, phi

    def _point_mass_field(self, rho, mass, geom=None):
        """A central point mass (Castro_pointmass.cpp): g adds -G M rhat / r^2
        about the problem centre."""
        geom = geom if geom is not None else self.geom
        r, center = self._radius_and_center(geom)
        r = r.expand(rho.shape)
        rsafe = torch.clamp(r, min=0.5 * min(geom.dx))
        gmag = -C.Gconst * mass / (rsafe * rsafe)
        g = [torch.zeros_like(rho) for _ in range(3)]
        if geom.coord == CoordSys.SPHERICAL or geom.dim == 1:
            g[0] = gmag
        else:
            for d in range(geom.dim):
                x = geom.cell_centers(d, 0) - center[d]
                g[d] = gmag * x.expand(rho.shape) / rsafe
        return torch.stack(g)

    # -- ConstantGrav ---------------------------------------------------------
    def _constant(self, rho):
        g = [torch.zeros_like(rho) for _ in range(3)]
        g[self.vert] = torch.full_like(rho, self.const_grav)
        return torch.stack(g), None

    # -- MonopoleGrav -----------------------------------------------------------
    def _radius_and_center(self, geom=None):
        """The radius at cell centres and the centre: the origin along axes
        with a symmetry lower boundary, else the domain centre; 1D
        spherical: the r coordinate, centre None."""
        geom = geom if geom is not None else self.geom
        if geom.coord == CoordSys.SPHERICAL:
            return geom.cell_centers(0, 0).expand(tuple(geom.n_cell)), None
        center = []
        for d in range(geom.dim):
            lo_sym = self.params.castro.lo_bc[d] in (3, 4, 5)
            center.append(geom.prob_lo[d] if lo_sym
                          else 0.5 * (geom.prob_lo[d] + geom.prob_hi[d]))
        r2 = 0.0
        for d in range(geom.dim):
            x = geom.cell_centers(d, 0) - center[d]
            r2 = r2 + x * x
        return torch.sqrt(r2), center

    def _monopole(self, rho, ctx=None):
        """Radial mass binning -> enclosed mass -> g = -G M(<r)/r^2 (reference
        `make_radial_gravity` + `interpolate_monopole_grav`)."""
        geom = ctx.geom if ctx is not None else self.geom
        r, center = self._radius_and_center(geom)
        r = r.expand(rho.shape)
        dr = min(self.geom.dx) / max(self.params.gravity.drdxfac, 1)
        # the largest radius: the domain's diagonal (the level's geometry)
        rmax = 0.0
        for d in range(self.geom.dim):
            span = self.geom.prob_hi[d] - self.geom.prob_lo[d]
            rmax += span * span
        rmax = math.sqrt(rmax)
        nbins = int(np.ceil(rmax / dr)) + 2

        vol = geom.volume(0).expand(rho.shape)
        ibin = torch.clamp((r / dr).to(torch.int64), 0, nbins - 1)
        mass_in_bin = torch.zeros(nbins, dtype=rho.dtype, device=rho.device).index_add_(
            0, ibin.reshape(-1), (rho * vol).reshape(-1))
        if ctx is not None:
            mass_in_bin = ctx.psum(mass_in_bin)
        m_enc = torch.cumsum(mass_in_bin, 0)  # mass inside edge (i+1)*dr
        # the enclosed mass at each cell's radius
        m_lo = torch.cat([torch.zeros(1, dtype=m_enc.dtype, device=m_enc.device), m_enc[:-1]])
        w = torch.clamp(r / dr - ibin, 0.0, 1.0)
        m_r = (1.0 - w) * m_lo[ibin] + w * m_enc[ibin]
        rsafe2 = torch.clamp(r, min=0.5 * dr) ** 2
        gr = -C.Gconst * m_r / rsafe2
        g = [torch.zeros_like(rho) for _ in range(3)]
        if geom.coord == CoordSys.SPHERICAL or geom.dim == 1:
            g[0] = gr
        else:
            rsafe = torch.clamp(r, min=1e-30)
            for d in range(geom.dim):
                x = geom.cell_centers(d, 0) - center[d]
                g[d] = gr * x.expand(rho.shape) / rsafe
        return torch.stack(g), None

    # -- PoissonGrav ------------------------------------------------------------
    def _poisson(self, rho, ctx=None):
        geom = ctx.geom if ctx is not None else self.geom
        rhs = 4.0 * math.pi * C.Gconst * rho
        if geom.coord != CoordSys.CARTESIAN:
            return self._poisson_curvilinear(rho, ctx)
        grav_bc = ctx.grav_bc if ctx is not None else None
        if grav_bc is not None:
            # the composite AMR level solve: Dirichlet phi interpolated from
            # the coarse level's solution on the window's faces (reference
            # level solve with coarse boundary registers, Gravity.cpp:418-487)
            bc_lo = bc_hi = ("dirichlet",) * geom.dim
            bvl, bvh = grav_bc
        elif self.periodic:
            bc_lo = bc_hi = ("periodic",) * geom.dim
            bvl = bvh = None
        else:
            # isolated BCs: multipole (or direct-sum) Dirichlet values on the
            # domain faces (reference fill_multipole_BCs, Gravity.cpp:1579-1743)
            bc_lo = bc_hi = ("dirichlet",) * geom.dim
            if self.params.gravity.direct_sum_bcs:
                bvl, bvh = self._direct_sum_bcs(rho, geom, ctx)
            else:
                bvl, bvh = self._multipole_bcs(rho, geom, ctx)
        phi, _ = mg.poisson(rhs, self.geom.dx, bc_lo=bc_lo, bc_hi=bc_hi, bc_vals_lo=bvl,
                            bc_vals_hi=bvh, n_vcycles=self.n_vcycles, rtol=self.rtol,
                            stats=self.solve_stats)
        g = self._grad_phi(phi, bvl, bvh, dirichlet=grav_bc is not None)
        return g, phi

    def _direct_sum_bcs(self, rho, geom, ctx=None):
        """The boundary potential by direct summation over every cell
        (reference `fill_direct_sum_BCs`, Gravity.cpp:1745-1910;
        gravity.direct_sum_bcs=1): phi(x_face) = -G sum_c rho_c dV /
        |x_face - x_c|, O(N_face * N_cell)."""
        dim = geom.dim
        dV = 1.0
        for d in range(dim):
            dV = dV * geom.dx[d]
        centers = [geom.cell_centers_1d(d, 0) for d in range(dim)]
        mesh_c = torch.meshgrid(*centers, indexing="ij")
        xc = torch.stack([m.reshape(-1) for m in mesh_c])  # [dim, N]
        mass = (rho * dV).reshape(-1)
        psum = ctx.psum if ctx is not None else (lambda x: x)
        bvl, bvh = [], []
        for d in range(dim):
            for side in ("lo", "hi"):
                coords = []
                for k in range(dim):
                    if k == d:
                        xf = geom.prob_lo[k] if side == "lo" else geom.prob_hi[k]
                        coords.append(torch.tensor([xf], dtype=rho.dtype, device=rho.device))
                    else:
                        coords.append(centers[k])
                target = tuple(1 if k == d else geom.n_cell[k] for k in range(dim))
                fm = torch.meshgrid(*coords, indexing="ij")
                xf_pts = torch.stack([m.reshape(-1) for m in fm])  # [dim, F]
                r2 = torch.zeros((xf_pts.shape[1], xc.shape[1]), dtype=rho.dtype,
                                 device=rho.device)
                for k in range(dim):
                    r2 = r2 + (xf_pts[k][:, None] - xc[k][None, :]) ** 2
                inv_r = 1.0 / torch.sqrt(torch.clamp(r2, min=1e-300))
                phi = -C.Gconst * psum(inv_r @ mass)
                (bvl if side == "lo" else bvh).append(phi.reshape(target))
        return tuple(bvl), tuple(bvh)

    def _multipole_bcs(self, rho, geom, ctx=None):
        """The multipole boundary potential on each domain face (reference
        `fill_multipole_BCs`, Gravity.cpp:1579-1743): real spherical-harmonic
        moments of rho up to l = gravity.max_multipole_order at the face
        cells' centres; l = 0 is the monopole -G M / r."""
        lnum = int(self.params.gravity.max_multipole_order)
        vol = geom.volume(0).expand(rho.shape)
        r, center = self._radius_and_center(geom)
        if center is None:
            center = [0.0] * geom.dim

        if lnum <= 0:
            mtot = torch.sum(rho * vol)
            if ctx is not None:
                mtot = ctx.psum(mtot)
            bvl = [self._face_phi(mtot, center, d, "lo", geom) for d in range(geom.dim)]
            bvh = [self._face_phi(mtot, center, d, "hi", geom) for d in range(geom.dim)]
            return bvl, bvh

        # moments q_i = sum rho vol (r/r_ref)^l Y_i: radii over a domain
        # scale keep the moments in float32 range (rho vol r^2 ~ 1e43 in cgs
        # overflows it); the face evaluation divides the scale back out
        r_ref = max(0.5 * (self.geom.prob_hi[d] - self.geom.prob_lo[d])
                    for d in range(geom.dim))

        def angles(xyz, rr):
            z = xyz[2] if geom.dim == 3 else torch.zeros_like(rr)
            pos = rr > 0
            cost = torch.where(pos, z / torch.where(pos, rr, torch.ones_like(rr)),
                               torch.zeros_like(rr))
            return cost, torch.atan2(xyz[1], xyz[0])

        xyz = []
        for d in range(3):
            if d < geom.dim:
                xyz.append((geom.cell_centers(d, 0) - center[d]).expand(rho.shape))
            else:
                xyz.append(torch.zeros_like(rho))
        cost, phi_ang = angles(xyz, r)
        moments = []
        for l, Y in _real_sph_harm(lnum, cost, phi_ang):
            q = torch.sum(rho * vol * (r / r_ref) ** l * Y)
            if ctx is not None:
                q = ctx.psum(q)
            moments.append((l, q))

        def face_vals(d, side):
            coords = []
            for k in range(geom.dim):
                if k == d:
                    xk = (geom.prob_lo[k] if side == "lo" else geom.prob_hi[k]) - center[k]
                    coords.append(torch.full((1,) * geom.dim, xk, dtype=geom.dtype,
                                             device=rho.device))
                else:
                    coords.append(geom.cell_centers(k, 0) - center[k])
            target = tuple(geom.n_cell[k] if k != d else 1 for k in range(geom.dim))
            fx = [c.expand(target) for c in coords]
            while len(fx) < 3:
                fx.append(torch.zeros(target, dtype=geom.dtype, device=rho.device))
            rr = torch.sqrt(sum(c * c for c in fx))
            rr = torch.clamp(rr, min=1e-3 * r_ref)
            cost_f, phi_f = angles(fx, rr)
            Yf = _real_sph_harm(lnum, cost_f, phi_f)
            # phi = -G sum 4pi/(2l+1) q_norm Y / (rr (rr/r_ref)^l): the moments'
            # r_ref^l divides back out through the scaled radius
            s = rr / r_ref
            phi_val = 0.0
            for (l, q), (_, Y) in zip(moments, Yf):
                phi_val = phi_val - C.Gconst * (4.0 * math.pi / (2 * l + 1)) \
                    * q * Y / (rr * s ** l)
            return phi_val

        bvl = [face_vals(d, "lo") for d in range(geom.dim)]
        bvh = [face_vals(d, "hi") for d in range(geom.dim)]
        return bvl, bvh

    def _face_phi(self, mtot, center, d, side, geom=None):
        """The monopole potential -G M / r on one domain face (the face
        plane's cell-centre positions)."""
        geom = geom if geom is not None else self.geom
        dim = geom.dim
        coords = []
        for k in range(dim):
            if k == d:
                x = geom.prob_lo[k] if side == "lo" else geom.prob_hi[k]
                coords.append(torch.tensor(x, dtype=geom.dtype, device=mtot.device) - center[k])
            else:
                coords.append(geom.cell_centers(k, 0) - center[k])
        r2 = 0.0
        for x in coords:
            r2 = r2 + x * x
        r = torch.sqrt(r2)
        face = -C.Gconst * mtot / torch.clamp(r, min=1e-30)
        target = [geom.n_cell[k] if k != d else 1 for k in range(dim)]
        return face.expand(tuple(target))

    def _grad_phi(self, phi, bvl, bvh, dirichlet=False):
        """g = -grad(phi), centred differences; at the domain faces against
        the BC ghost (reference get_new_grav_vector)."""
        geom = self.geom
        dim = geom.dim
        pad_codes = (mg.PERIODIC,) * dim if (self.periodic and not dirichlet) \
            else (mg.DIRICHLET,) * dim
        if self.periodic:
            phi_g = mg._fill(mg._grow(phi), pad_codes, pad_codes)
        else:
            phi_g = mg._fill(mg._grow(phi), pad_codes, pad_codes, bvl, bvh)
        g = [torch.zeros_like(phi) for _ in range(3)]
        for d in range(dim):
            v = phi_g
            for k in range(dim):
                if k != d:
                    v = v.narrow(k, 1, v.shape[k] - 2)
            n = v.shape[d] - 2
            g[d] = -(v.narrow(d, 2, n) - v.narrow(d, 0, n)) / (2.0 * geom.dx[d])
        return torch.stack(g)

    def _poisson_curvilinear(self, rho, ctx=None):
        """1D spherical / 2D RZ: the monopole solution, which is exact in 1D
        spherical (the reference does the same above max_solve_level)."""
        return self._monopole(rho, ctx)
