"""Meshes over an initialised process group (functions only: importing
this module starts no process group and touches no device): agent meshes
for the sharded and distributed consensus plans, and the data x model
meshes of the LM zoo (:func:`make_production_mesh`,
:func:`make_host_mesh`, placed by :mod:`repro_torch.sharding.rules`).

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
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
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


def _world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialised process group: call "
            "init_local_group(rank, world_size, store_file) (or "
            "torch.distributed.init_process_group) in every process first")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_agent_mesh(positions: int = 0, axis_name: str = "agents",
                    device_type: Optional[str] = None):
    """1-D ``DeviceMesh`` over the initialised process group whose
    ``axis_name`` axis carries agents. An agent mesh spans the whole
    group: ``positions`` is 0 (every process) or the group's world size,
    and any other value is refused. ``device_type`` defaults to ``"cuda"``
    under NCCL and ``"cpu"`` otherwise. The counterpart of the JAX
    package's ``repro.launch.mesh.make_agent_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world(f"make_agent_mesh(positions={positions}, axis_name="
                   f"{axis_name!r})")
    if positions not in (0, world):
        raise ValueError(
            f"positions={positions} is not the group's world size {world}: "
            "an agent mesh spans the whole group; pass positions=0, or "
            f"start the group with world_size={positions}")
    return init_device_mesh(_device_type(device_type), (world,),
                            mesh_dim_names=(axis_name,))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The JAX package's production mesh as a ``DeviceMesh``: 16 x 16 = 256
    ranks on axes (``data``, ``model``), or 2 x 16 x 16 = 512 on (``pod``,
    ``data``, ``model``). The group must have exactly that many ranks; on
    one host that is a ``FakeStore`` group (``backend="fake"``), for
    placements and shapes, with no compute."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world("make_production_mesh")
    if world != int(np.prod(shape)):
        raise ValueError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{shape} needs {int(np.prod(shape))} ranks, the group has "
            f"{world}: start it with that world size (a FakeStore group "
            "for a dry run), or use make_host_mesh(data, model)")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: Optional[str] = None):
    """A (``data``, ``model``) ``DeviceMesh`` over the group's ranks, each
    size clamped as the JAX package clamps to its devices: data to the
    world size, model to world // data. The clamped mesh must cover the
    whole group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world(f"make_host_mesh(data={data}, model={model})")
    data = min(data, n)
    model = min(model, max(n // data, 1))
    if data * model != n:
        raise ValueError(
            f"make_host_mesh(data={data}, model={model}) covers "
            f"{data * model} of the group's {n} ranks: a mesh spans the "
            "whole group; pick sizes whose product is the world size")
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def _group_worker(rank, world, store, backend, fn, args, results):
    """One rank of :func:`run_on_group`: join the group, run ``fn``,
    report (rank, value) or (rank, traceback)."""
    try:
        init_local_group(rank, world, store, backend=backend)
        results.put((rank, fn(rank, world, *args)))
    except Exception:               # a worker boundary: report, then exit
        results.put((rank, traceback.format_exc()))
    finally:
        destroy_local_group()


def run_on_group(world: int, fn: Callable, *args, backend: str = "gloo",
                 timeout_s: float = 120.0) -> list:
    """Spawn ``world`` processes on this host, join them in a group
    through a file store (no address, no network) and run ``fn(rank,
    world, *args)`` in each (``fn`` a module-level function, its value
    picklable). Returns the values in rank order; raises with every
    failed rank's traceback, or if a rank reports nothing within
    ``timeout_s``. Every process is joined or terminated on return."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_group_worker,
                             args=(r, world, store, backend, fn, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        name = getattr(fn, "__name__", fn)
        try:
            while len(got) < world:
                try:
                    rank, value = results.get(timeout=1.0)
                except queue_lib.Empty:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"{name}: {world - len(got)} of {world} ranks "
                            f"reported nothing within {timeout_s} s") from None
                    if not any(p.is_alive() for p in procs) and \
                            results.empty():
                        raise RuntimeError(
                            f"{name}: {world - len(got)} of {world} ranks "
                            "exited without reporting (exit codes "
                            f"{[p.exitcode for p in procs]})") from None
                    continue
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    bad = {r: v for r, v in got.items() if isinstance(v, str)}
    if bad:
        raise RuntimeError(f"{name} failed:\n"
                           + "\n".join(f"--- rank {r} ---\n{tb}"
                                       for r, tb in sorted(bad.items())))
    return [got[r] for r in range(world)]
