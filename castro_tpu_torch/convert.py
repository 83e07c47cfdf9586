"""Carry state across from the JAX package: a conserved state given as a
numpy array, the same `Params` from the same inputs text, and a restart from
the checkpoint directory `castro_tpu/driver/io.py:write_checkpoint` writes
(`state.npz` + `meta.json`), and an AMR hierarchy (levels, windows, masks
and extra windows) as numpy. Castro has no weights: the conserved state and
the parameters are what must agree. The native `.cio` blob form waits for
the port of `utils/native.py` (ROADMAP.md)."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from castro_tpu_torch.config import Params, parse_inputs_text

CHECKPOINT_VERSION = 1


def state_from_numpy(u, layout, device, dtype) -> torch.Tensor:
    """A component-major state [NVAR, grid...] as a tensor; the component
    count must match the layout."""
    u = np.asarray(u)
    if u.ndim != layout.dim + 1 or u.shape[0] != layout.NVAR:
        raise ValueError(f"state of shape {u.shape} does not match the layout "
                         f"(NVAR={layout.NVAR}, dim={layout.dim})")
    return torch.tensor(u, dtype=dtype, device=device).contiguous()


def params_from_inputs_text(text: str) -> Params:
    """The same Params the JAX package parses from the same inputs text."""
    return parse_inputs_text(text)


def _rad_from_numpy(a, device, dtype):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _face_fields(data, suffix=""):
    """The three MHD face fields `u_b0{suffix}` .. `u_b2{suffix}` of a
    checkpoint's arrays, or None."""
    if f"u_b0{suffix}" not in data:
        return None
    return tuple(np.asarray(data[f"u_b{d}{suffix}"]) for d in range(3))


def _b_from_numpy(b, device, dtype):
    return None if b is None else tuple(
        torch.tensor(np.asarray(bb), dtype=dtype, device=device) for bb in b)


def restart_from_jax_checkpoint(sim, path: str):
    """Restore `sim` (state, radiation Er, the MHD face fields, t, step, dt,
    the point mass) from a JAX checkpoint directory, with the state-variable
    check of the reference restart (Castro_io.cpp:42). The checkpoint's
    `u_rad` (`castro_tpu/driver/io.py:78-79`) is the radiation state of a
    radiation run, interior [n...] gray or [ngroups, n...]; its `u_b0` ..
    `u_b2` (`:80-82`) the grown face fields of an MHD run."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] > CHECKPOINT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} too new")
    if meta["state_variables"] != list(sim.layout.cons_names):
        raise ValueError(
            "checkpoint state variables do not match this build: "
            f"{meta['state_variables']} vs {list(sim.layout.cons_names)}")
    if os.path.exists(os.path.join(path, "state.cio")):
        raise NotImplementedError("the native .cio checkpoint form is not ported "
                                  "(ROADMAP.md, queue 1 item 14)")
    with np.load(os.path.join(path, "state.npz")) as data:
        u = data["u"]
        u_rad = data["u_rad"] if "u_rad" in data else None
        u_b = _face_fields(data)
    if (u_rad is not None) != (getattr(sim, "rad", None) is not None):
        raise ValueError("checkpoint and simulation differ in castro.do_radiation")
    if (u_b is not None) != (getattr(sim, "mhd", None) is not None):
        raise ValueError("checkpoint and simulation differ in castro.do_mhd")
    if tuple(u.shape[1:]) != sim.grown_shape():
        raise ValueError(f"checkpoint grid {u.shape[1:]} does not match {sim.grown_shape()}")
    sim.u = state_from_numpy(u, sim.layout, sim.device, sim.dtype)
    if u_rad is not None:
        sim.u_rad = _rad_from_numpy(u_rad, sim.device, sim.dtype)
    if u_b is not None:
        sim.u_b = _b_from_numpy(u_b, sim.device, sim.dtype)
    sim.t = meta["time"]
    sim.step_count = meta["step"]
    sim.dt = meta["dt"]
    sim.num_zones_advanced = meta.get("num_zones_advanced", 0)
    if "point_mass" in meta:  # accreted with point_mass_fix_solution
        sim.point_mass = meta["point_mass"]
    return sim


def hierarchy_to_numpy(amr) -> dict:
    """An AMR hierarchy's state as numpy: per level `u`, `u_old` (None
    where a level has not stepped yet), `u_rad` and `u_rad_old` (radiation
    Er per level, None without radiation; the form of the JAX checkpoint's
    `u_rad_<l>`, `castro_tpu/driver/io.py:226-227`), `u_b` and `u_b_old`
    (the three MHD face fields per level, None without MHD; the JAX
    checkpoint's `u_b<d>_<l>`, `:228-230`), `window` ((ilo,
    shape); level 0 the whole domain), `masks` and `extra` (per level, a
    list of {ilo, shape, u, mask}), and `t`, `step_count`, `dt`. The JAX
    package's `AmrSimulation` has the same attributes, so the same reading
    of it gives the form `restore_hierarchy` takes."""
    def arr(a):
        if a is None:
            return None
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def faces(b):
        return None if b is None else tuple(arr(bb) for bb in b)

    none = [None] * len(amr.u)
    return {
        "u": [arr(a) for a in amr.u], "u_old": [arr(a) for a in amr.u_old],
        "u_rad": [arr(a) for a in getattr(amr, "u_rad", none)],
        "u_rad_old": [arr(a) for a in getattr(amr, "u_rad_old", none)],
        "u_b": [faces(b) for b in getattr(amr, "u_b", none)],
        "u_b_old": [faces(b) for b in getattr(amr, "u_b_old", none)],
        "masks": [arr(m) for m in amr.masks],
        "window": [None if w is None else (np.asarray(w[0], int).copy(), tuple(w[1]))
                   for w in amr.window],
        "extra": [[{"ilo": np.asarray(e["ilo"], int).copy(), "shape": tuple(e["shape"]),
                    "u": arr(e["u"]), "mask": arr(e["mask"])} for e in lvl]
                  for lvl in amr.extra],
        "t": float(amr.t), "step_count": int(amr.step_count),
        "dt": None if amr.dt is None else float(amr.dt)}


def restore_hierarchy(amr, state: dict):
    """Set the port's `AmrSimulation` to a hierarchy given as numpy (the
    form of `hierarchy_to_numpy`, from either package): levels, radiation
    Er (old and new), the MHD face fields (old and new), windows, masks,
    extra windows, time and step count, on the hierarchy's device and in
    its dtype. The windows must fit the hierarchy's levels."""
    if len(state["u"]) != amr.max_level + 1:
        raise ValueError(f"hierarchy of {len(state['u'])} levels, expected {amr.max_level + 1}")
    L, dev, dt = amr.sim0.layout, amr.device, amr.dtype

    def tens(a):
        return None if a is None else state_from_numpy(a, L, dev, dt)

    def mask(m):
        return None if m is None else torch.tensor(np.asarray(m, bool), device=dev)

    amr.u = [tens(a) for a in state["u"]]
    amr.u_old = [tens(a) for a in state.get("u_old", [None] * len(state["u"]))]
    none = [None] * len(state["u"])
    if amr._has_rad != any(a is not None for a in state.get("u_rad", none)):
        raise ValueError("hierarchy and simulation differ in castro.do_radiation")
    amr.u_rad = [_rad_from_numpy(a, dev, dt) for a in state.get("u_rad", none)]
    amr.u_rad_old = [_rad_from_numpy(a, dev, dt) for a in state.get("u_rad_old", none)]
    if amr._has_rad:
        amr.sim0.u_rad = amr.u_rad[0]
    if amr._has_mhd != any(b is not None for b in state.get("u_b", none)):
        raise ValueError("hierarchy and simulation differ in castro.do_mhd")
    amr.u_b = [_b_from_numpy(b, dev, dt) for b in state.get("u_b", none)]
    amr.u_b_old = [_b_from_numpy(b, dev, dt) for b in state.get("u_b_old", none)]
    if amr._has_mhd:
        amr.sim0.u_b = amr.u_b[0]
    amr.masks = [mask(m) for m in state["masks"]]
    amr.window = [None if w is None else (np.asarray(w[0], int).copy(), tuple(int(s) for s in w[1]))
                  for w in state["window"]]
    amr.extra = [[{"ilo": np.asarray(e["ilo"], int).copy(),
                   "shape": tuple(int(s) for s in e["shape"]), "u": tens(e["u"]),
                   "mask": mask(e["mask"])} for e in lvl] for lvl in state["extra"]]
    amr.sim0.u = amr.u[0]
    amr.t = float(state["t"])
    amr.step_count = int(state["step_count"])
    amr.dt = state.get("dt")
    return amr
