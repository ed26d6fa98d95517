"""The sharded programs as captured CUDA graphs: the counterpart of the JAX
package's `jax.jit(jax.shard_map(...))` (parallel/dist_ba.py,
parallel/traj_ba.py, parallel/dist_match.py, parallel/dryrun.py).

A sharded program runs every shard's work in one Python loop over the
mesh (parallel/mesh.py). Where every shard of the mesh is one and the same
CUDA device (a virtual mesh of one card) the whole loop, collectives
included, is one stream's work, and the program replays it from captured
graphs: `MeshLoopProgram` (an LM loop: an enter and a step graph,
utils/graphs.LoopProgram) and `MeshGraphProgram` (a function captured
whole, utils/graphs.GraphProgram without a seed). On the CPU, and on a
mesh over several distinct devices, the program is its eager function,
decided from the mesh before anything runs: one stream capture cannot hold
work on several devices. A body that cannot be captured raises; the
program never runs the eager function instead.

The key of a graph is the input tensors' shapes, dtypes and devices and
the static `MeshKey`: the configuration, the mesh's devices along the
axis, the axis name and (the landmark-sharded BA) the reduction. A `Mesh`
itself holds a dict and does not hash.
"""

from __future__ import annotations

from typing import NamedTuple

from visualslam_tpu_torch.ops.cuda import reads_host
from visualslam_tpu_torch.utils.graphs import GraphProgram, LoopProgram, _map


class MeshKey(NamedTuple):
    """A sharded program's static arguments: `cfg` (BAConfig, SlamConfig
    or None), the mesh's `devices` along `axis`, and the landmark-sharded
    BA's `reduce` ("" elsewhere)."""

    cfg: object
    devices: tuple
    axis: str
    reduce: str = ""

    @property
    def iters(self) -> int:
        """The LM iterations (a MeshLoopProgram replays its step graph
        this many times)."""
        return self.cfg.iters


def on_one_card(devices) -> bool:
    """True where every shard is one and the same CUDA device: a sharded
    program replays graphs there."""
    return devices[0].type == "cuda" and all(d == devices[0]
                                             for d in devices)


def mesh_input(x, devices):
    """x with every tensor on the mesh's one card where the program
    replays (a copy from elsewhere is made here, outside any capture: the
    graphs read x there), as it is elsewhere (the eager function moves
    each shard itself)."""
    if not on_one_card(devices):
        return x
    return _map(lambda v: v.to(devices[0]), x)


class MeshLoopProgram(LoopProgram):
    """A sharded LM loop, called as program(x, MeshKey): graphs on one
    card, the eager function elsewhere (utils/graphs.LoopProgram says the
    rest)."""

    def _replays(self, x, cfg: MeshKey) -> bool:
        return on_one_card(cfg.devices)


class MeshGraphProgram(GraphProgram):
    """A sharded function captured whole, called as program(x, (MeshKey,
    kernels)): graphs on one card, the eager function elsewhere and for a
    kernel set whose solvers read the host (utils/graphs.GraphProgram says
    the rest). kernels is None for a program that runs none of the
    switchable kernels."""

    def __init__(self, fn):
        super().__init__(fn, seeded=False)

    def _replays(self, x, cfg) -> bool:
        key, kernels = cfg
        return on_one_card(key.devices) and (kernels is None
                                             or not reads_host(kernels))
