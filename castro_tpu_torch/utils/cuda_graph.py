"""CUDA-graph replay of a fixed-shape loop body (the spherical march's
shell, the burner's iteration, the NSE temperature's bisection, a
multigrid solve's V-cycle): these are launch-bound, hundreds to tens of
thousands of small launches an iteration, with no host read inside."""

from __future__ import annotations

import gc
from collections import OrderedDict
from functools import partial

import torch


def capture(body, device, collect=True):
    """Run `body` once eagerly on a side stream (it fills every lazy cache:
    constants made on first use would be host-to-device copies, which a
    capture refuses), then capture one call of it into a CUDA graph and
    return the graph. The eager call's work stands; the capture runs
    nothing. The cyclic garbage collector is off while the graph is
    captured: a collection there can free an earlier graph (a dead
    simulation's burner holds its graphs in a reference cycle), whose
    teardown is not allowed during a capture and invalidates it. With
    `collect` a full collection first frees what dead cycles hold; a
    graph captured every solve (the multigrid's) passes False: with a
    simulation's objects alive a full collection costs as much as a small
    solve (PERF.md)."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if collect:
        gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            body()
    finally:
        if enabled:
            gc.enable()
    return graph


class GraphLoop:
    """A loop whose body, body(state), updates a list of tensors in place
    with the same operations on every iteration. On a CUDA device the body
    is captured once for each set of shapes and dtypes of the state, over
    static copies of it; a call copies the state into them and replays
    the graph. Elsewhere, or with graph=False, the body runs eagerly on
    the state itself. The `keep` graphs used last are kept: each holds a
    memory pool of its own."""

    def __init__(self, body, keep=2):
        self.body = body
        self.keep = keep
        self.graphs = OrderedDict()

    def __call__(self, state, n, more=None, graph=True):
        """Up to n iterations, each run only while more(state) holds (the
        loop's one host read, where given). Returns (iterations, the state
        after them): on the card the static copies, which the next call
        overwrites."""
        if graph and state[0].is_cuda:
            key = tuple((tuple(v.shape), v.dtype, v.device) for v in state)
            if key in self.graphs:
                self.graphs.move_to_end(key)
            else:
                while len(self.graphs) >= self.keep:
                    self.graphs.popitem(last=False)
                static = [v.clone() for v in state]
                self.graphs[key] = (capture(lambda: self.body(static), state[0].device), static)
            g, live = self.graphs[key]
            for buf, v in zip(live, state):
                buf.copy_(v)
            step = g.replay
        else:
            live = state
            step = partial(self.body, state)
        it = 0
        while it < n and (more is None or more(live)):
            step()
            it += 1
        return it, live
