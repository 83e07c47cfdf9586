"""Command-line driver: `python -m castro_tpu_torch [inputs] problem=sedov
[ns.key=value ...] [device=cpu]`, the counterpart of `python -m castro_tpu`
(reference `Source/driver/main.cpp:33`): parse inputs, run the
coarse-timestep loop on the card, print the STEP lines and the FOM.
problem= one of sedov, sod, acoustic_pulse (double Mach reflection, which
needs its fill hook, is built with `problems.double_mach.build`, and is
not on the command line, as in the JAX package)."""

from __future__ import annotations

import sys

from castro_tpu_torch.config import load_inputs, parse_inputs_text


def main(argv=None):
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import acoustic_pulse, sedov, sod

    problems = {"sedov": (sedov.make_params, sedov.problem_init),
                "sod": (sod.make_params, sod.problem_init),
                "acoustic_pulse": (acoustic_pulse.make_params, acoustic_pulse.problem_init)}
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    inputs_path, problem, device, overrides = None, None, None, []
    for a in argv:
        if a.startswith("problem="):
            problem = a.split("=", 1)[1]
        elif a.startswith("device="):
            device = a.split("=", 1)[1]
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
    params = make_params()
    if inputs_path:
        params = load_inputs(inputs_path, base=params)
    if overrides:
        params = parse_inputs_text("\n".join(overrides), base=params)
    sim = Simulation(params, problem_init=init, device=device)
    sim.run(verbose=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
