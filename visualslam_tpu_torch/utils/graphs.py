"""Captured CUDA graphs: the PyTorch counterpart of the JAX package's
compiled programs.

A jitted JAX program is traced once per shape and static argument and then
dispatched as one compiled unit. On the card its counterpart is a CUDA
graph: a body of device work captured once over static buffers and
replayed with a single host call. This module holds what every captured
program of the port shares:

  * the tree helpers (`_leaves`, `_map`, `_signature`, `_static`,
    `_copy_all`, `_assign`, `_clone_all`) that keep a body's inputs and
    results in static tensors a graph can read and write on every replay;
  * `_Graph` (one body captured, its kernel launches counted per replay),
    `_Capture` (the eager warm-up on a side stream, the captures, the
    2-NN scratch rule) and `_Uncaptured` (the same body run as it is);
  * `_KeyGraphs` (a key's static inputs and captured bodies) and
    `_Program` (the keyed cache of the most recently used keys, and the
    dispatch between replaying and the eager function), which the two
    program kinds below share;
  * `LoopProgram`: a solver of the form enter -> `cfg.iters` x step ->
    result (the LM loops of the pose graph and of bundle adjustment, the
    JAX package's `lax.scan` over a fixed carry) as two graphs per shape
    key, an enter graph and a step graph replayed `cfg.iters` times;
  * `GraphProgram`: its one-graph sibling, a function captured whole per
    shape key: the two-view init's RANSAC and pose recovery, with a
    generator of its own for the random draws inside it, and (seeded=False)
    the frontends, which draw nothing.

`slam/engine.py` builds its programs from the same pieces, and
`parallel/programs.py` keys both kinds on a mesh for the sharded
programs.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch

from visualslam_tpu_torch.geometry.ransac import generator
from visualslam_tpu_torch.ops.cuda import (
    add_launch_counts,
    distance,
    launch_counts,
    reads_host,
    set_launch_counts,
)
from visualslam_tpu_torch.utils.precision import f32_matmul
from visualslam_tpu_torch.utils.profiling import span


def _leaves(tree) -> list:
    """The tensors of nested NamedTuples and lists, in order."""
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _map(fn, tree):
    """fn of every tensor of nested NamedTuples and tuples, in their
    structure."""
    if isinstance(tree, tuple):
        out = (_map(fn, x) for x in tree)
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def _signature(*trees) -> tuple:
    """Shape, dtype and device of every tensor: what a capture bakes in."""
    return tuple((tuple(x.shape), x.dtype, x.device)
                 for t in trees for x in _leaves(t))


def _static(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _copy_all(dst: list, src: list) -> None:
    """dst[k].copy_(src[k]) for every pair that is not one tensor, in the
    fewest launches torch offers (its multi-tensor copy)."""
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _assign(dst, src) -> None:
    """Copy a body's results into the static tensors they replace (inside
    a capture the copies become part of the graph)."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise RuntimeError(f"captured program: a result of "
                               f"{tuple(s.shape)} {s.dtype} for a static "
                               f"{tuple(d.shape)} {d.dtype}")
        d.copy_(s)


def _clone_all(tree):
    out = _map(torch.empty_like, tree)
    _copy_all(_leaves(out), _leaves(tree))
    return out


class _Graph:
    """One body captured as a CUDA graph: its outputs (tensors of the
    graph's private pool, rewritten by every replay) and the launches of
    each counted kernel (ops.cuda.COUNTED) that one replay makes. A capture
    runs the kernels' wrappers without launching anything, so the counters
    are put back after it and advanced on every replay instead. A body
    that cannot be captured (a host sync, a pageable copy) raises here.
    `generators`: the CUDA generators the body draws from other than the
    default one, registered with the graph (capture refuses an unregistered
    one); each replay draws from the state a generator has at that time."""

    def __init__(self, body, generators=()):
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(self.graph):
                self.out = body()
        finally:
            after = launch_counts()
            set_launch_counts(before)
        self.launches = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}

    def replay(self):
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.out


class _Capture:
    """Bodies warmed up eagerly on a side stream (library handles and
    workspaces, the kernels' builds, the 2-NN scratch), then captured as
    _Graphs. The 2-NN's scratch is the capture's own: the warm-up sizes it
    and no capture regrows it (a graph keeps the pointers its capture
    saw), so the program must hold `scratch` as long as its graphs.
    `done` gives the seconds since the start and the device memory the
    program now holds (a capture empties the allocator's cache; so do the
    start and the end here, so the difference counts what stays). From
    construction to `done` the capture is the span `capture`."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.scratch: dict = {}
        self._span = span("capture")
        self._span.__enter__()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self._t0 = time.perf_counter()
        self._reserved = torch.cuda.memory_reserved(dev)

    def warm_up(self, fn) -> None:
        cur = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side), \
                distance.owned_scratch(self.scratch, grow=True):
            fn()
        cur.wait_stream(side)

    def graph(self, body, generators=()) -> _Graph:
        with distance.owned_scratch(self.scratch, grow=False):
            return _Graph(body, generators)

    def done(self) -> tuple[float, int]:
        torch.cuda.synchronize(self.dev)
        torch.cuda.empty_cache()
        self._span.__exit__(None, None, None)
        return (time.perf_counter() - self._t0,
                torch.cuda.memory_reserved(self.dev) - self._reserved)


class _Uncaptured:
    """A body run as it is on every replay: `_BatchGraphs(graphs=False)`,
    `LoopGraphs(graphs=False)` and `ProgramGraph(graphs=False)`, which run
    a graph program's data flow on any device (the CPU tests' view of
    it)."""

    def __init__(self, body):
        self.body = body
        self.out = None

    def replay(self):
        self.out = self.body()
        return self.out




# ---------------------------------------------------------------------
# what both program kinds share: static inputs, graphs, the keyed cache
# ---------------------------------------------------------------------


class _KeyGraphs:
    """One shape key of a program: static copies of the inputs, and the
    bodies over them captured as graphs (or, with graphs=False, run as they
    are, on any device). `capture_s` and `pool_bytes` give the seconds and
    the device memory the key's statics and graphs' private pools took."""

    def __init__(self, x, graphs: bool):
        self._cap = _Capture(_leaves(x)[0].device) if graphs else None
        self.x = _map(_static, x)
        _copy_all(_leaves(self.x), _leaves(x))
        self.capture_s, self.pool_bytes = 0.0, 0

    def _capture(self, warm_up, bodies, generators=()) -> None:
        """`graphs`: the bodies' graphs, in order, captured after warm_up()
        ran eagerly on a side stream; a body may read the graphs captured
        before it there (the list fills as they are captured)."""
        self.graphs: list = []
        if self._cap is None:
            self.graphs.extend(_Uncaptured(b) for b in bodies)
            return
        cap, self._cap = self._cap, None
        cap.warm_up(warm_up)
        for body in bodies:
            self.graphs.append(cap.graph(body, generators))
        self.scratch = cap.scratch      # the graphs read it: keep it alive
        self.capture_s, self.pool_bytes = cap.done()


class _Program:
    """A function `fn(x, cfg)` compiled per key (the JAX package's
    `jax.jit(fn, static_argnums=1)`): x a NamedTuple or tuple of tensors,
    cfg a frozen, hashable configuration. On a CUDA device a call replays
    the graphs of its key, the shape, dtype and device of every input
    tensor and cfg (jit's cache on the shapes and the static argument),
    captured by the key's first call (`_key_graphs`); a body that cannot be
    captured raises, and the call never runs the function eagerly instead.
    Where `_replays` is false (the CPU: the caller asked for it) the
    program is `fn` itself. Replays run on the current stream, one call at
    a time per program.

    The cache keeps the KEYS most recently used keys and drops the least
    recently used one past that (its graphs and their pools with it)."""

    # The callers use one shape at a time: the loop closer one capacity (it
    # only grows, doubling past 256 nodes), the host-path window BA its
    # fixed padding, the global BA one problem (new shapes at every call)
    # and its warm rerun, the tracker its match capacity, the mesh
    # tracker's sharded window BA its shards' observation padding.
    # Four keys hold those and a prepared key with room to spare, and bound
    # what a run whose shapes keep changing can hold on the card.
    KEYS = 4

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = fn.__name__ + "_jit"
        self.__doc__ = fn.__doc__
        self.captured: OrderedDict = OrderedDict()

    def _key_graphs(self, x, cfg) -> _KeyGraphs:
        raise NotImplementedError

    def _replays(self, x, cfg) -> bool:
        return _leaves(x)[0].device.type == "cuda"

    def _graphs(self, x, cfg) -> _KeyGraphs:
        f32_matmul()
        key = (_signature(x), cfg)
        graphs = self.captured.get(key)
        if graphs is None:
            graphs = self._key_graphs(x, cfg)
            while len(self.captured) >= self.KEYS:
                self.captured.popitem(last=False)
            self.captured[key] = graphs
        self.captured.move_to_end(key)
        return graphs

    def prepare(self, x, cfg) -> None:
        """Capture the graphs of x's shapes and cfg without running them
        (where the program does not replay: nothing to prepare)."""
        if self._replays(x, cfg):
            self._graphs(x, cfg)


# ---------------------------------------------------------------------
# LoopProgram: enter, cfg.iters steps over a static carry, result
# ---------------------------------------------------------------------


class LoopGraphs(_KeyGraphs):
    """One shape key of a LoopProgram: static copies of the inputs and of
    the carry, an enter graph (the loop's set-up: plans, initial cost and
    damping, written into the carry; it returns the loop's constants, `aux`)
    and a step graph (one iteration, carry in, carry out), replayed
    `cfg.iters` times. `run` copies the caller's inputs in, replays, and
    returns copies of the result, so no later replay overwrites what a
    caller holds. graphs=False runs the same bodies over the same static
    buffers without capturing them, on any device."""

    def __init__(self, prog: "LoopProgram", x, cfg, graphs: bool = True):
        super().__init__(x, graphs)
        self.prog, self.cfg = prog, cfg
        # the carry's shapes and types, from one eager enter
        self.carry = _map(_static, prog.enter(self.x, cfg)[1])

        def enter():
            aux, c = prog.enter(self.x, cfg)
            _assign(self.carry, c)
            return aux

        def step(aux):
            _assign(self.carry, prog.step(self.x, cfg, aux, self.carry))

        self._capture(lambda: step(enter()),
                      [enter, lambda: step(self.graphs[0].out)])
        self.g_enter, self.g_step = self.graphs

    def run(self, x):
        _copy_all(_leaves(self.x), _leaves(x))
        aux = self.g_enter.replay()
        for _ in range(self.cfg.iters):
            self.g_step.replay()
        return _clone_all(self.prog.result(self.x, self.cfg, aux,
                                           self.carry))


class LoopProgram(_Program):
    """A solver `fn(x, cfg)` that runs enter, `cfg.iters` steps and result
    (the JAX package's jitted `lax.scan`), called as program(x, cfg):

      enter(x, cfg)               -> (aux, carry): the loop's constants
                                     (the segment-sum plans, the initial
                                     cost) and its first carry
      step(x, cfg, aux, carry)    -> the next carry
      result(x, cfg, aux, carry)  -> what fn returns

    `fn` itself runs the three in that order, eagerly; so on the card the
    graphs launch the eager function's kernels in the eager function's
    order, and their results equal its bits. A key holds LoopGraphs: the
    first call of a key captures them after an eager warm-up of enter and
    one step (`_Program` says the rest)."""

    def __init__(self, fn, enter, step, result):
        super().__init__(fn)
        self.enter, self.step, self.result = enter, step, result

    def _key_graphs(self, x, cfg) -> LoopGraphs:
        return LoopGraphs(self, x, cfg)

    def __call__(self, x, cfg):
        if not self._replays(x, cfg):
            return self.fn(x, cfg)
        return self._graphs(x, cfg).run(x)


# ---------------------------------------------------------------------
# GraphProgram: a function captured whole, with or without a seed
# ---------------------------------------------------------------------


class ProgramGraph(_KeyGraphs):
    """One shape key of a GraphProgram: static copies of the inputs and
    one graph of the function over them, whose outputs live in the graph's
    pool. `run` copies the caller's inputs in, seeds the program's
    generator (a seeded program), replays, and returns copies of the
    outputs, so no later replay overwrites what a caller holds (the
    tracker's lag-1 stream holds one batch's features across the next
    batch's frontend). graphs=False runs the same body over the same static
    buffers without capturing it, on any device."""

    def __init__(self, prog: "GraphProgram", x, cfg, graphs: bool = True):
        super().__init__(x, graphs)
        gens = ((prog.generator(_leaves(x)[0].device),) if prog.seeded
                else ())
        self.gen = gens[0] if gens else None

        def body():
            return prog.fn(self.x, cfg, *gens)

        self._capture(body, [body], gens)
        self.graph, = self.graphs

    def run(self, x, *seed: int):
        _copy_all(_leaves(self.x), _leaves(x))
        if self.gen is not None:
            # the replay draws what a fresh generator(seed) draws eagerly:
            # seeding resets the generator's offset, which the replay reads
            self.gen.manual_seed(int(seed[0]))
        return _clone_all(self.graph.replay())


class GraphProgram(_Program):
    """A function captured whole per shape key (`_Program` says the rest;
    a key holds one ProgramGraph, captured on the key's first call after an
    eager warm-up on a side stream). cfg = (config, kernels).

    seeded (the default): `fn(x, cfg, gen)` draws its random numbers from
    gen and is called as program(x, cfg, seed); the draws are those of
    `geometry.ransac.generator(seed)` on the inputs' device. The program
    owns one generator per device, registered with every graph it captures
    there, and seeds it before each replay.
    seeded=False: `fn(x, cfg)` draws nothing and is called as
    program(x, cfg) (the frontends).

    With a kernel set whose solvers read the host (`ops.cuda.reads_host`:
    the plain path's cuSOLVER status reads), as on the CPU, the program is
    `fn` itself, decided from the arguments before anything runs."""

    def __init__(self, fn, seeded: bool = True):
        super().__init__(fn)
        self.seeded = seeded
        self.generators: dict = {}

    def generator(self, dev: torch.device) -> torch.Generator:
        """The program's generator on `dev` (registered with its graphs
        there)."""
        gen = self.generators.get(dev)
        if gen is None:
            gen = self.generators[dev] = torch.Generator(device=dev)
        return gen

    def _key_graphs(self, x, cfg) -> ProgramGraph:
        return ProgramGraph(self, x, cfg)

    def _replays(self, x, cfg) -> bool:
        return super()._replays(x, cfg) and not reads_host(cfg[1])

    def __call__(self, x, cfg, *seed: int):
        if len(seed) != int(self.seeded):
            raise TypeError(f"{self.__name__} takes (x, cfg"
                            f"{', seed' if self.seeded else ''})")
        if not self._replays(x, cfg):
            gens = ((generator(seed[0], _leaves(x)[0].device),)
                    if self.seeded else ())
            return self.fn(x, cfg, *gens)
        return self._graphs(x, cfg).run(x, *seed)
