"""Agent meshes for the sharded and distributed consensus plans
(functions only: importing this module starts no process group and
touches no device).

A mesh is a one-dimensional ``torch.distributed.device_mesh.DeviceMesh``
over an initialised process group whose axis carries consensus agents:
one agent per position for the engine's ``distributed`` plan, a block of
agents per position for ``sharded``. Each process then passes only its
own rows to ``ConsensusEngine.step``.

:func:`init_local_group` starts a group on this host through a file
store (``init_method="file://..."``): no address, no port, no network.
Gloo runs it on the CPU in any number of processes; NCCL needs one card
per process, so one card runs world size 1.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist


def init_local_group(rank: int, world_size: int, store_file: str, *,
                     backend: str = "gloo", timeout_s: float = 120.0):
    """Join (or, at rank 0, start) a process group of ``world_size``
    processes on this host, rendezvousing through ``store_file`` (a path
    every process can reach; it must not exist before the first process
    starts). ``backend="nccl"`` binds rank r to card r first."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group is already initialised (world size "
            f"{dist.get_world_size()}); call destroy_local_group() first "
            "or reuse it")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{store_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def destroy_local_group():
    """Tear down this process's group (a no-op if none is running)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_agent_mesh(positions: int = 0, axis_name: str = "agents",
                    device_type: Optional[str] = None):
    """1-D ``DeviceMesh`` over the initialised process group whose
    ``axis_name`` axis carries agents. An agent mesh spans the whole
    group: ``positions`` is 0 (every process) or the group's world size,
    and any other value is refused. ``device_type`` defaults to ``"cuda"``
    under NCCL and ``"cpu"`` otherwise. The counterpart of the JAX
    package's ``repro.launch.mesh.make_agent_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"make_agent_mesh(positions={positions}, axis_name="
            f"{axis_name!r}) needs an initialised process group: call "
            "init_local_group(rank, world_size, store_file) (or "
            "torch.distributed.init_process_group) in every process first")
    world = dist.get_world_size()
    if positions not in (0, world):
        raise ValueError(
            f"positions={positions} is not the group's world size {world}: "
            "an agent mesh spans the whole group; pass positions=0, or "
            f"start the group with world_size={positions}")
    positions = world
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (positions,),
                            mesh_dim_names=(axis_name,))
