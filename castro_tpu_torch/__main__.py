"""Command-line driver: `python -m castro_tpu_torch [inputs] problem=sedov
[ns.key=value ...] [device=cpu]`, the counterpart of `python -m castro_tpu`
(reference `Source/driver/main.cpp:33`): parse inputs, run the
coarse-timestep loop on the card, print the STEP lines and the FOM.
problem= one of sedov, sod, acoustic_pulse, detonation, burning_blob,
dust_collapse, double_mach, flame_wave or hse_convergence. detonation is
the 1D reacting shock tube (powerlaw network, Strang burns), burning_blob
the 3D iso7 blob
(physics=full: with Poisson gravity and the sponge, the JAX package's
full-physics configuration); network.network_name= and
eos.eos_name=helmholtz swap in a stellar network and EOS. dust_collapse is
the self-gravitating collapse, 1D spherical with monopole gravity, or
(dim=3) 3D Cartesian with Poisson gravity. double_mach, flame_wave (2D,
aprox13 + Helmholtz + conduction + constant gravity, an HSE lower face)
and hse_convergence (1D, HSE fills on both faces) are built by their
problems' `build` with their fill hooks, at their own sizes, and ignore
overrides, as in the JAX package (flame_wave sets no stop time or step
count: it runs until interrupted, as the JAX CLI's does). With
amr.max_level > 0 the run is an `AmrSimulation` (regrids every
amr.regrid_int steps, tags from amr.refinement_indicators), e.g.

    python -m castro_tpu_torch problem=sedov amr.n_cell="128 128 128" \
        amr.max_level=1 amr.refinement_indicators=denerr \
        amr.denerr.field=pressure amr.denerr.relative_gradient=0.1 \
        amr.max_step=10 tpu.dtype=float32"""

from __future__ import annotations

import sys

from castro_tpu_torch.config import load_inputs, parse_inputs_text


def main(argv=None):
    from castro_tpu_torch.driver.amr import AmrSimulation
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import (acoustic_pulse, burning_blob, detonation,
                                           double_mach, dust_collapse, flame_wave,
                                           hse_convergence, sedov, sod)

    problems = {"sedov": (sedov.make_params, sedov.problem_init),
                "sod": (sod.make_params, sod.problem_init),
                "acoustic_pulse": (acoustic_pulse.make_params, acoustic_pulse.problem_init),
                "detonation": (detonation.make_params, detonation.problem_init),
                "burning_blob": (burning_blob.make_params, burning_blob.problem_init),
                "dust_collapse": (dust_collapse.make_params, dust_collapse.problem_init),
                # custom construction (the fill hooks)
                "double_mach": ("build", double_mach.build),
                "flame_wave": ("build", flame_wave.build),
                "hse_convergence": ("build", hse_convergence.build)}
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    inputs_path, problem, device, overrides, setup = None, None, None, [], {}
    for a in argv:
        if a.startswith("problem="):
            problem = a.split("=", 1)[1]
        elif a.startswith("device="):
            device = a.split("=", 1)[1]
        elif a.startswith("physics="):  # burning_blob's physics set
            setup["physics"] = a.split("=", 1)[1]
        elif a.startswith("dim="):  # dust_collapse's 1D or 3D setup
            setup["dim"] = int(a.split("=", 1)[1])
        elif "=" in a:
            overrides.append(a.replace("=", " = ", 1))
        else:
            inputs_path = a
    if problem is None and inputs_path:
        path = inputs_path.lower().replace("_", "").replace("-", "")
        problem = next((name for name in problems if name.replace("_", "") in path), None)
    if problem not in problems:
        print(f"unknown problem {problem!r} (have: {sorted(problems)})")
        return 1
    make_params, init = problems[problem]
    if make_params == "build":
        for ov in overrides:
            print(f"note: override {ov.split(' = ')[0]} ignored: {problem} sets its own inputs")
        sim = init(device=device)
        sim.init_data()
        sim.run(verbose=True)
        return 0
    params = make_params(**setup)
    if inputs_path:
        params = load_inputs(inputs_path, base=params)
    if overrides:
        params = parse_inputs_text("\n".join(overrides), base=params)
    if params.amr.max_level > 0:
        sim = AmrSimulation(params, problem_init=init, device=device)
    else:
        sim = Simulation(params, problem_init=init, device=device)
    sim.run(verbose=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
