"""Carry state across from the JAX package: a conserved state given as a
numpy array, the same `Params` from the same inputs text, and a restart from
the checkpoint directory `castro_tpu/driver/io.py:write_checkpoint` writes
(`state.npz` + `meta.json`). Castro has no weights: the conserved state and
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


def restart_from_jax_checkpoint(sim, path: str):
    """Restore `sim` (state, t, step, dt) from a JAX checkpoint directory,
    with the state-variable check of the reference restart (Castro_io.cpp:42)."""
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
    if tuple(u.shape[1:]) != sim.grown_shape():
        raise ValueError(f"checkpoint grid {u.shape[1:]} does not match {sim.grown_shape()}")
    sim.u = state_from_numpy(u, sim.layout, sim.device, sim.dtype)
    sim.t = meta["time"]
    sim.step_count = meta["step"]
    sim.dt = meta["dt"]
    sim.num_zones_advanced = meta.get("num_zones_advanced", 0)
    return sim
