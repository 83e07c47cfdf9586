"""Runtime configuration: Castro-compatible `inputs` files -> typed params.

The reference declares ~200 runtime parameters in a DSL table
(`Source/driver/_cpp_parameters`) code-generated into ParmParse queries, and
reads namespaced `inputs` files via AMReX ParmParse (`Source/driver/main.cpp`).
Here the same namespaces (`castro.*`, `amr.*`, `geometry.*`, `gravity.*`,
`diffusion.*`, `radiation.*`, `problem.*`, ...) are parsed into a tree of
frozen dataclasses so that reference problem inputs files port unchanged.
Physics toggles are plain Python values read when a Simulation is built,
instead of preprocessor defines (reference: `Exec/Make.Castro:52-118`).

This is the PyTorch package's own copy of `castro_tpu/config.py`: the same
inputs files parse to the same values. The `tpu.*` namespace keeps its
name so that those files need no change; of it this package reads
`tpu.dtype`.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _tup(*xs):
    return tuple(xs)


@dataclass(frozen=True)
class GeometryParams:
    """Namespace `geometry.*` (AMReX Geometry conventions)."""

    coord_sys: int = 0  # 0=Cartesian, 1=cylindrical (r-z), 2=spherical (r)
    prob_lo: Tuple[float, ...] = (0.0, 0.0, 0.0)
    prob_hi: Tuple[float, ...] = (1.0, 1.0, 1.0)
    is_periodic: Tuple[int, ...] = (0, 0, 0)


@dataclass(frozen=True)
class AmrParams:
    """Namespace `amr.*` (reference: AMReX Amr class runtime params)."""

    n_cell: Tuple[int, ...] = (64,)
    max_level: int = 0
    ref_ratio: Tuple[int, ...] = (2, 2, 2, 2)
    blocking_factor: int = 8
    max_grid_size: int = 64
    regrid_int: int = 2
    n_error_buf: int = 2
    # distributed-AMR: shard the PRIMARY fine window's step over the mesh
    # (instead of computing it replicated on every device); opt-in — it
    # compiles one extra shard_map program per window shape
    distribute_fine: int = 0
    plot_int: int = -1
    plot_per: float = -1.0
    check_int: int = -1
    check_per: float = -1.0
    plot_file: str = "plt"
    check_file: str = "chk"
    plot_vars: Tuple[str, ...] = ("ALL",)
    derive_plot_vars: Tuple[str, ...] = ()
    small_plot_vars: Tuple[str, ...] = ()
    max_step: int = -1
    stop_time: float = -1.0
    subcycling_mode: str = "Auto"
    refinement_indicators: Tuple[str, ...] = ()
    data_log: Tuple[str, ...] = ()


@dataclass(frozen=True)
class CastroParams:
    """Namespace `castro.*`.

    Defaults mirror the reference parameter table
    (`Source/driver/_cpp_parameters`); only behavior-relevant entries are
    reproduced — everything else lands in `Params.extra`.
    """

    # -- timestep control (reference `_cpp_parameters` "timestep control")
    cfl: float = 0.8
    init_shrink: float = 1.0
    change_max: float = 1.1
    fixed_dt: float = -1.0
    initial_dt: float = -1.0
    max_dt: float = 1.0e200
    dt_cutoff: float = 1.0e-12
    use_retry: int = 1
    retry_subcycle_factor: float = 0.5
    max_subcycles: int = 10
    # -- hydro
    do_hydro: int = 1
    ppm_type: int = 1  # 0=PLM, 1=PPM
    ppm_temp_fix: int = 0
    plm_iorder: int = 2
    plm_limiter: int = 2
    use_flattening: int = 1
    riemann_solver: int = 0  # 0=CGF two-shock, 1=Colella-Glaz iterative, 2=HLLC
    cg_maxiter: int = 12
    cg_tol: float = 1.0e-5
    cg_blend: int = 2
    hybrid_riemann: int = 0
    difmag: float = 0.1
    use_pslope: int = 0
    pslope_cutoff_density: float = -1.0e20
    transverse_use_eos: int = 0
    transverse_reset_density: int = 1
    transverse_reset_rhoe: int = 0
    #: re-evaluate interface (p, rho e) via the EOS after transverse
    #: corrections (edge_util.cpp reset_edge_state_thermo)
    transverse_use_eos: int = 0
    do_ctu: int = 1  # 1 = CTU, 0 = method of lines
    sdc_order: int = 2  # for true SDC (time_integration_method=2)
    sdc_quadrature: int = 0  # 0 = Gauss-Lobatto, 1 = Radau IIA
    time_integration_method: int = 0  # 0=CTU+Strang, 1=(removed), 2=SDC, 3=simplified SDC
    fourth_order: int = 0
    limit_fluxes_on_small_dens: int = 0
    speed_limit: float = 0.0
    check_cfl_violation: int = 1  # retry when courant > 1 (Castro_hydro.cpp:234)
    #: lagged momentum-source predictor to t+dt/2 (Castro.cpp:3780-3836)
    source_term_predictor: int = 0
    hydro_memory_footprint_ratio: float = -1.0
    # -- state cleaning / floors
    small_dens: float = 1.0e-200
    small_temp: float = 1.0e-200
    small_pres: float = 1.0e-200
    small_ener: float = -1.0e200
    small: float = 1.0e-8
    dual_energy_eta1: float = 1.0
    dual_energy_eta2: float = 1.0e-4
    normalize_species: int = 1  # reference default is 0 but every prod setup sets 1
    density_reset_method: int = 1
    allow_small_energy: int = 1
    clamp_ambient_temp: int = 0
    # -- BCs (per-face integer codes, AMReX phys_bc convention)
    lo_bc: Tuple[int, ...] = (0, 0, 0)
    hi_bc: Tuple[int, ...] = (0, 0, 0)
    # -- gravity/rotation/physics toggles
    do_grav: int = 0
    do_rotation: int = 0
    do_react: int = 0
    do_radiation: int = 0
    do_sponge: int = 0
    add_ext_src: int = 0
    do_thermal_diffusion: int = 0  # reference: diffuse_temp
    diffuse_temp: int = 0
    diffuse_cutoff_density: float = -1.0e20
    diffuse_cutoff_density_hi: float = -1.0e20
    diffuse_cond_scale_fac: float = 1.0
    # -- rotation details (reference Source/rotation)
    rotational_period: float = -1.0e200
    rotation_include_centrifugal: int = 1
    rotation_include_coriolis: int = 1
    state_in_rotating_frame: int = 1
    rot_source_type: int = 4
    implicit_rotation_update: int = 1
    rot_axis: int = 3
    # -- gravity source details
    grav_source_type: int = 4
    moving_center: int = 0
    point_mass: float = 0.0
    point_mass_fix_solution: int = 0
    use_point_mass: int = 0
    # -- reactions
    dtnuc_e: float = 1.0e200
    dtnuc_X: float = 1.0e200
    dtnuc_X_threshold: float = 1.0e-3
    react_T_min: float = 0.0
    react_T_max: float = 1.0e200
    react_rho_min: float = 0.0
    react_rho_max: float = 1.0e200
    disable_shock_burning: int = 0
    # -- sponge
    sponge_lower_radius: float = -1.0
    sponge_upper_radius: float = -1.0
    sponge_lower_density: float = -1.0
    sponge_upper_density: float = -1.0
    sponge_lower_pressure: float = -1.0
    sponge_upper_pressure: float = -1.0
    sponge_timescale: float = -1.0
    sponge_implicit: int = 1
    sponge_target_x_velocity: float = 0.0
    sponge_target_y_velocity: float = 0.0
    sponge_target_z_velocity: float = 0.0
    # -- diagnostics / verbosity
    v: int = 0
    sum_interval: int = -1
    sum_per: float = -1.0
    job_name: str = ""
    # -- misc physics
    use_shock_var: int = 0
    hybrid_momentum: int = 0
    #: evolve UMR/UML/UMP with their own fluxes (Castro_hybrid.cpp)
    hybrid_hydro: int = 0
    gw_dist: float = -1.0  # kpc; >0 enables gwstrain diagnostics (Castro.H:961)
    do_scf_initial_model: int = 0
    scf_maximum_density: float = -1e6
    scf_equatorial_radius: float = -1e9
    scf_polar_radius: float = -1e9
    scf_relax_tol: float = 1e-3
    scf_max_iterations: int = 30
    ambient_fill_dir: int = -1
    ambient_outflow_vel: int = 0
    clamp_hse_bcs: int = 0  # fill_hse BC usage is via lo/hi_bc codes
    shock_detection_threshold: float = 0.6666666666666667
    # -- MHD
    do_mhd: int = 0
    #: limit MHD PLM slopes on characteristic variables (mhd_plm.cpp)
    mhd_limit_characteristic: int = 1
    #: 3D MHD integrator: 1 = reference CTU-CT (12-solve corner-coupled
    #: constrained transport), 0 = SSP-RK2 + flux-CT
    mhd_ctu: int = 1
    mhd_plm_slope: int = 2
    # -- tracer particles
    do_tracer_particles: int = 0


@dataclass(frozen=True)
class GravityParams:
    """Namespace `gravity.*` (reference: `Source/gravity/Gravity.cpp:110-141`)."""

    gravity_type: str = "ConstantGrav"  # ConstantGrav | MonopoleGrav | PoissonGrav
    const_grav: float = 0.0
    direct_sum_bcs: int = 0
    max_multipole_order: int = 0  # lnum
    abs_tol: float = 1.0e-11
    rel_tol: float = 1.0e-11
    max_solve_level: int = 20
    no_sync: int = 0
    do_composite_phi_correction: int = 1
    drdxfac: int = 1
    v: int = 0
    mlmg_max_fmg_iter: int = 0
    mlmg_agglomeration: int = 1
    mlmg_consolidation: int = 1


@dataclass(frozen=True)
class DiffusionParams:
    """Namespace `diffusion.*`."""

    v: int = 0
    mlmg_maxorder: int = 4


@dataclass(frozen=True)
class RadiationParams:
    """Namespace `radiation.*` (reference: `Source/radiation/Radiation.cpp`)."""

    ngroups: int = 1
    solver_flag: int = 5  # 5 = gray SGFLD, 6 = multigroup MGFLD
    limiter: int = 2  # 0=none(Eddington), 2=Levermore-Pomraning, 12/22/32/42 variants
    closure: int = 3
    reltol: float = 1.0e-6
    abstol: float = 1.0e-6
    maxiter: int = 50
    update_limiter: int = 1000
    delta_temp: float = 1.0
    prop_temp_floor: float = 0.0
    const_kappa_p: float = -1.0
    kappa_p_exp_m: float = 0.0
    kappa_p_exp_n: float = 0.0
    kappa_p_exp_p: float = 0.0
    const_kappa_r: float = -1.0
    kappa_r_exp_m: float = 0.0
    kappa_r_exp_n: float = 0.0
    kappa_r_exp_p: float = 0.0
    const_scattering: float = 0.0
    scattering_exp_m: float = 0.0
    scattering_exp_n: float = 0.0
    scattering_exp_p: float = 0.0
    kappa_floor: float = 0.0
    # Compton group-to-group exchange after the implicit update
    # (Radiation::inelastic_scattering, MGFLD.cpp:1655)
    do_inelastic_scattering: int = 0
    do_real_eos: int = 1
    c_light_scale: float = 1.0  # reference radiation.c -> fudge factors
    outer_iters: int = 8  # matter-coupling outer iterations (maxiter analog)
    accelerate: int = 2  # MGFLD group-iteration acceleration: 0=off, 2=gray_accel
    lo_bc: Tuple[int, ...] = (0, 0, 0)
    hi_bc: Tuple[int, ...] = (0, 0, 0)
    lo_bcflag: Tuple[int, ...] = (0, 0, 0)
    hi_bcflag: Tuple[int, ...] = (0, 0, 0)
    lo_bcval: Tuple[float, ...] = (0.0, 0.0, 0.0)
    hi_bcval: Tuple[float, ...] = (0.0, 0.0, 0.0)
    lowest_group_energy: float = 0.5e-3  # keV-era defaults unused unless MG
    highest_group_energy: float = 300.0
    # frequency-group layout (reference RadMultiGroup.cpp: lowestGroupHz /
    # highestGroupHz log-uniform, or groupGrowFactor geometric widths)
    lowest_group_hz: float = -1.0
    highest_group_hz: float = -1.0
    group_grow_factor: float = -1.0
    first_group_width_hz: float = -1.0
    # comoving-frame f-space advection flavor (Castro_ctu_rad.cpp:42)
    fspace_advection_type: int = 1
    comoving: int = 1
    # radiation flattening threshold (radiation::flatten_pp_threshold,
    # Castro_ctu_hydro.cpp:241)
    flatten_pp_threshold: float = -1.0
    # 1 = characteristic CTU rad-hydro coupling (trace_ppm_rad +
    # ctu_rad_consup, the reference scheme); 0 = operator-split Er
    # advection (kept for AMR-window and sharded paths)
    hydro_coupling: int = 1
    # Purser spatial filters (Radiation.cpp:53-136 / filter.H)
    filter_lambda_T: int = 0
    filter_lambda_S: int = -1  # accepted for parity; S=0 members built in
    filter_prim_int: int = 0
    filter_prim_T: int = 4
    filter_prim_S: int = 0
    v: int = 0


@dataclass(frozen=True)
class RadSolveParams:
    """Namespace `radsolve.*` — linear-solver knobs for the FLD solve."""

    level_solver_flag: int = 1
    reltol: float = 1.0e-10
    abstol: float = 1.0e-10
    maxiter: int = 40
    v: int = 0


@dataclass(frozen=True)
class ParticlesParams:
    """Namespace `particles.*` (reference `Source/particles/CastroParticles.cpp`)."""

    particle_init_file: str = ""
    particle_restart_file: str = ""
    restart_from_nonparticle_chkfile: int = 0
    particle_output_file: str = ""
    timestamp_dir: str = ""
    timestamp_density: int = 1
    timestamp_temperature: int = 0
    v: int = 0


@dataclass(frozen=True)
class EosParams:
    """Namespace `eos.*` — EOS selection + constants (reference: Microphysics)."""

    eos_name: str = "gamma_law"  # gamma_law | polytrope | multigamma | rad_power_law | helmholtz
    eos_gamma: float = 1.6666666666666667
    eos_assume_neutral: int = 1
    polytrope_K: float = 1.0
    polytrope_gamma: float = 1.6666666666666667
    polytrope_type: int = 0
    polytrope_mu_e: float = 2.0


@dataclass(frozen=True)
class NetworkParams:
    """Namespace `network.*` — reaction network selection."""

    network_name: str = "general_null"
    nspec: int = 1
    spec_names: Tuple[str, ...] = ("X",)
    aux_names: Tuple[str, ...] = ()
    # powerlaw-network constants
    rtilde: float = 1.0
    nu: float = 4.0
    specific_q_burn: float = 10.0
    T_burn_ref: float = 1.0
    rho_burn_ref: float = 1.0
    f_act: float = 1.0
    # NSE coupling (reference Microphysics nse_tabular: in_nse when rho/T
    # exceed the thresholds and the composition is iron-group-like)
    nse: int = 0
    rho_nse: float = 2.0e8
    T_nse: float = 5.0e9
    T_always_nse: float = 1.0e10


@dataclass(frozen=True)
class IntegratorParams:
    """Namespace `integrator.*` — stiff-ODE burner settings (reference: VODE)."""

    rtol_spec: float = 1.0e-12
    atol_spec: float = 1.0e-8
    rtol_enuc: float = 1.0e-6
    atol_enuc: float = 1.0e-6
    jacobian: int = 1  # 1 = analytic, 2 = numerical
    maxiter: int = 100
    ode_max_steps: int = 150000
    call_eos_in_rhs: int = 1


@dataclass(frozen=True)
class TpuParams:
    """Namespace `tpu.*` — new-framework-only knobs (no reference analog).

    Compute dtype, device mesh layout for spatial domain decomposition, and
    patch sizes for the AMR patch-batch representation. The PyTorch package
    reads `dtype` only.
    """

    dtype: str = "float32"  # compute dtype: float32 | float64 (tests/CPU)
    mesh_shape: Tuple[int, ...] = ()  # e.g. (2,2,2); empty = single device
    mesh_axes: Tuple[str, ...] = ("mx", "my", "mz")
    patch_size: int = 32  # AMR fixed patch edge length (cells)
    donate_state: int = 1
    profile: int = 0  # phase timers (TinyProfiler analog)
    #: fused-face-kernel fallback threshold: max product of the two
    #: in-VMEM-block grid extents before the CTU face stages fall back to
    #: the plain XLA path. 0 = no cap (large grids use narrow tiles).
    pallas_max_inblock_area: int = 0


@dataclass(frozen=True)
class Params:
    geometry: GeometryParams = field(default_factory=GeometryParams)
    amr: AmrParams = field(default_factory=AmrParams)
    castro: CastroParams = field(default_factory=CastroParams)
    gravity: GravityParams = field(default_factory=GravityParams)
    diffusion: DiffusionParams = field(default_factory=DiffusionParams)
    radiation: RadiationParams = field(default_factory=RadiationParams)
    radsolve: RadSolveParams = field(default_factory=RadSolveParams)
    particles: ParticlesParams = field(default_factory=ParticlesParams)
    eos: EosParams = field(default_factory=EosParams)
    network: NetworkParams = field(default_factory=NetworkParams)
    integrator: IntegratorParams = field(default_factory=IntegratorParams)
    tpu: TpuParams = field(default_factory=TpuParams)
    # free-form problem namespace (`problem.*`), like `_prob_params`
    problem: Dict[str, Any] = field(default_factory=dict)
    # any unrecognized key lands here as "<ns>.<key>" -> parsed value
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def dim(self) -> int:
        return len(self.amr.n_cell)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)

    def with_ns(self, ns: str, **kw) -> "Params":
        """Return a copy with fields of one namespace replaced."""
        return dataclasses.replace(self, **{ns: dataclasses.replace(getattr(self, ns), **kw)})


_NAMESPACES = {
    "geometry": GeometryParams,
    "amr": AmrParams,
    "castro": CastroParams,
    "gravity": GravityParams,
    "diffusion": DiffusionParams,
    "radiation": RadiationParams,
    "radsolve": RadSolveParams,
    "particles": ParticlesParams,
    "eos": EosParams,
    "network": NetworkParams,
    "integrator": IntegratorParams,
    "tpu": TpuParams,
}


def _parse_token(tok: str) -> Any:
    """Parse one whitespace token into int/float/str (ParmParse semantics)."""
    t = tok.strip().strip('"')
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


def _coerce(value_tokens, ftype):
    """Coerce a list of parsed tokens to a dataclass field type."""
    origin = typing.get_origin(ftype)
    if origin is tuple:
        args = typing.get_args(ftype)
        elem = args[0] if args else Any
        if elem is float:
            return tuple(float(v) for v in value_tokens)
        if elem is int:
            return tuple(int(v) for v in value_tokens)
        if elem is str:
            return tuple(str(v) for v in value_tokens)
        return tuple(value_tokens)
    # scalar field: ParmParse-style, take the first token if several
    v = value_tokens[0]
    if ftype is float:
        return float(v)
    if ftype is int:
        return int(float(v))
    if ftype is str:
        return str(v)
    return v if len(value_tokens) == 1 else value_tokens


def parse_inputs_text(text: str, base: Optional[Params] = None) -> Params:
    """Parse a Castro/AMReX `inputs` file body into Params.

    Grammar (AMReX ParmParse): `ns.key = v1 [v2 ...]`, `#` comments,
    bare `key = ...` for top-level keys (max_step, stop_time map to amr).
    """
    p = base if base is not None else Params()
    ns_values: Dict[str, Dict[str, Any]] = {k: {} for k in _NAMESPACES}
    problem: Dict[str, Any] = dict(p.problem)
    extra: Dict[str, Any] = dict(p.extra)

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        tokens = [_parse_token(t) for t in val.split()]
        if not tokens:
            continue
        if "." in key:
            ns, _, name = key.partition(".")
        else:
            # top-level keys: max_step / stop_time belong to the Amr driver
            ns, name = ("amr", key) if key in ("max_step", "stop_time") else ("", key)
        if ns == "problem" or ns == "prob":
            problem[name] = tokens[0] if len(tokens) == 1 else tuple(tokens)
            continue
        cls = _NAMESPACES.get(ns)
        if cls is None:
            extra[key] = tokens[0] if len(tokens) == 1 else tuple(tokens)
            continue
        fields = {f.name: f for f in dataclasses.fields(cls)}
        if name in fields:
            ns_values[ns][name] = _coerce(tokens, fields[name].type_resolved if hasattr(fields[name], "type_resolved") else typing.get_type_hints(cls)[name])
        else:
            extra[f"{ns}.{name}"] = tokens[0] if len(tokens) == 1 else tuple(tokens)

    updates = {}
    for ns, vals in ns_values.items():
        if vals:
            updates[ns] = dataclasses.replace(getattr(p, ns), **vals)
    return dataclasses.replace(p, problem=problem, extra=extra, **updates)


def load_inputs(path: str, base: Optional[Params] = None) -> Params:
    with open(path) as f:
        return parse_inputs_text(f.read(), base=base)
