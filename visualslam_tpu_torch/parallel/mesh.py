"""Device-mesh helpers (visualslam_tpu/parallel/mesh.py).

The engine's parallel axes:
  'data'  — frames / images: frontends are embarrassingly parallel
  'shard' — observation / landmark blocks inside BA

The JAX package runs one program over a `jax.sharding.Mesh` with
`shard_map`, from one process. The port keeps that single-controller
shape: a `Mesh` is a list of `torch.device`s, one per shard, and a sharded
solver runs every shard's work in one Python loop, with collectives as
explicit copies between the shards' tensors (parallel/collectives.py). A
mesh may name the same device several times: a virtual mesh, the
counterpart of `--xla_force_host_platform_device_count`, which runs 8
shards on the CPU or 4 on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """shape: axis name -> size (`mesh.shape["shard"]` as in JAX);
    axis_names: the axes in order; devices: one torch.device per shard,
    row-major over the axes."""

    shape: dict
    axis_names: tuple
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(d: torch.device) -> torch.device:
    """"cuda" -> "cuda:<current>", so that devices compare as tensors'
    devices do."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(n: int, devices) -> tuple:
    if devices is not None:
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        if len(devs) < n:
            raise RuntimeError(f"requested a {n}-device mesh but only "
                               f"{len(devs)} devices were given")
        return devs[:n]
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise RuntimeError(
            f"requested a {n}-device mesh but only {visible} CUDA devices "
            f"are visible; for a virtual mesh pass devices= (for example "
            f"[torch.device('cpu')] * {n})")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              devices=None) -> Mesh:
    """1-D mesh over the first n_devices CUDA devices (default: all
    visible), or over the caller's `devices` (repeats allowed)."""
    if n_devices is None:
        if devices is not None:
            n_devices = len(devices)
        elif torch.cuda.is_available():
            n_devices = torch.cuda.device_count()
        else:
            n_devices = 0
        if n_devices == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= for a CPU mesh")
    return Mesh({axis: n_devices}, (axis,), _devices(n_devices, devices))


def make_mesh_2d(n_data: int, n_shard: int, devices=None) -> Mesh:
    """[n_data, n_shard] mesh with axes ("data", "shard"), devices
    row-major."""
    return Mesh({"data": n_data, "shard": n_shard}, ("data", "shard"),
                _devices(n_data * n_shard, devices))


def axis_devices(mesh: Mesh, axis: str) -> tuple:
    """The devices of a 1-D mesh's shards along `axis` (the sharded
    solvers and collectives run over one axis)."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"expected a 1-D mesh over {axis!r}, got axes "
                         f"{mesh.axis_names}")
    return mesh.devices
