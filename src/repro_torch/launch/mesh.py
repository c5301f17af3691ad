"""Device meshes of the port (the counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2, data=16,
model=16) = 512, the 'pod' axis a second data-parallel axis. The meshes
are ``torch.distributed`` ``DeviceMesh`` objects with the JAX package's
axis names; their collectives run on NCCL on the card and on ``gloo``
where the caller asks for the CPU, and a backend never replaces the other.

Functions, not module constants: importing this module starts no process
group. ``make_host_mesh`` starts a world-1 group when none exists (one
card, or this process's CPU); the larger meshes need the caller's group of
that many ranks (``torch.distributed.init_process_group`` with its address,
world size and rank).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.ops import resolve_device


@dataclass(frozen=True)
class DeviceSpec:
    """Device sharding of a batched stream launch.

    ``n_devices`` splits the leading B axis of a batched stream launch
    (kernels/ops.stream_steps_batched) into ``n_devices`` equal slices,
    each launched on its own card (``cuda:0 … cuda:n-1``): streams never
    communicate (their recurrent states are per-stream), so the sharded
    launch is bit-identical to the unsharded one. A sharded plan needs that
    many cards on the host; the CPU path runs the slices one after another
    in this process. The default (n_devices=1) is the plain launch.
    ``axis`` names the mesh axis (the 'data' axis of the production
    meshes)."""

    n_devices: int = 1
    axis: str = "data"


def make_stream_mesh(spec: DeviceSpec, device="cuda") -> list:
    """The devices a ``spec``-sharded launch splits its batch over: the
    first ``n_devices`` cards, or ``n_devices`` slices of the CPU where
    ``device`` is the CPU (the counterpart of the JAX package's forced
    host device count)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * spec.n_devices
    have = torch.cuda.device_count()
    if have < spec.n_devices:
        raise RuntimeError(
            f"DeviceSpec wants {spec.n_devices} devices, have {have} — "
            "a sharded launch needs that many cards (device='cpu' runs "
            "the slices on the CPU)")
    return [torch.device("cuda", i) for i in range(spec.n_devices)]


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The production mesh over the caller's process group: (data 16,
    model 16), or (pod 2, data 16, model 16) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"need {need} ranks for mesh {shape}, have {have} — start "
            f"{need} processes with torch.distributed.init_process_group")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(device="cuda") -> DeviceMesh:
    """1x1 ('data', 'model') mesh on this process's device (the card unless
    the caller asks for the CPU). Without a process group it starts a
    world-1 one: NCCL for the card, ``gloo`` for the CPU."""
    dev_type = resolve_device(device).type
    if not dist.is_initialized():
        backend = "nccl" if dev_type == "cuda" else "gloo"
        # world 1: an in-process store, no address to pick
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    if dist.get_world_size() != 1:
        raise RuntimeError(
            f"make_host_mesh is a one-rank mesh; this process group has "
            f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev_type, (1, 1),
                            mesh_dim_names=("data", "model"))
