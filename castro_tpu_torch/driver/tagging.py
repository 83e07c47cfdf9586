"""Refinement tagging (counterpart of `castro_tpu/driver/tagging.py`;
reference: AMReX `AMRErrorTag` driven by `amr.refinement_indicators` +
`Castro::errorEst`, `Source/driver/Castro.cpp:560-615,3131-3160`, plus the
`problem_tagging.H` hook).

An indicator is a dict {field, test, value, max_level}, test one of
value_greater / value_less / gradient / relative_gradient. `field` is a
state name or a derived quantity of the JAX package's registry
(`castro_tpu/driver/derive.py`), of which the port has the pressure; the
rest of the registry comes with the I/O tools (ROADMAP.md, queue 1 item
14)."""

from __future__ import annotations

from typing import Dict, List

import torch

from castro_tpu_torch.ops.stencil import shifted


def _pressure(sim, u):
    """The derived pressure (`castro_tpu/driver/derive.py:derive_pressure`)."""
    L = sim.layout
    rho = u[L.URHO]
    rhoinv = 1.0 / rho
    xn = u[L.UFS: L.UFS + L.nspec] * rhoinv[None]
    return sim.eos.re(rho=rho, e=u[L.UEINT] * rhoinv, xn=xn).p


DERIVED = {"pressure": _pressure}


def _get_field(sim, u_int, name):
    names = sim.layout.cons_names
    if name in names:
        return u_int[names.index(name)]
    if name in DERIVED:
        return DERIVED[name](sim, u_int)
    raise NotImplementedError(
        f"tagging field '{name}' is neither a state component nor one of {sorted(DERIVED)}; "
        "the other derived quantities are not ported yet (queue 1 item 14, ROADMAP.md)")


def apply_indicator(sim, u_int, ind: Dict, level: int):
    """Boolean tag array for one indicator on interior data."""
    shape = tuple(u_int.shape[1:])
    if ind.get("max_level") is not None and level >= ind["max_level"]:
        return torch.zeros(shape, dtype=torch.bool, device=u_int.device)
    f = _get_field(sim, u_int, ind["field"])
    test = ind["test"]
    val = ind["value"]
    if test == "value_greater":
        return f > val
    if test == "value_less":
        return f < val
    if test in ("gradient", "relative_gradient"):
        tag = torch.zeros(shape, dtype=torch.bool, device=u_int.device)
        for d in range(sim.layout.dim):
            df = torch.maximum((shifted(f, 1, d) - f).abs(), (f - shifted(f, -1, d)).abs())
            if test == "relative_gradient":
                df = df / torch.clamp(f.abs(), min=1e-300)
            tag = tag | (df > val)
        return tag
    raise ValueError(f"unknown tagging test '{test}'")


def buffer_tags(tags, n_buf: int):
    """Grow tagged regions by n_buf cells (reference amr.n_error_buf)."""
    t = tags
    for _ in range(n_buf):
        grown = t
        for d in range(t.dim()):
            grown = grown | shifted(t, 1, d) | shifted(t, -1, d)
        t = grown
    return t


def tag_cells(sim, u_int, indicators: List[Dict], level: int, n_buf: int,
              problem_tagging=None):
    """The tags of every indicator and the problem's hook, buffered."""
    tags = torch.zeros(tuple(u_int.shape[1:]), dtype=torch.bool, device=u_int.device)
    for ind in indicators:
        tags = tags | apply_indicator(sim, u_int, ind, level)
    if problem_tagging is not None:
        tags = tags | problem_tagging(sim, u_int, level)
    return buffer_tags(tags, n_buf)
