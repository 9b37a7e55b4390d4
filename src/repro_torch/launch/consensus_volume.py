"""The paper's technique on the production mesh: per-round communication
volume of decentralized consensus (Eq. 6) against a FedAvg-style
all-reduce, and the bf16 message (the Eq.-(11) E_SL knob). The port's
twin of the JAX package's ``benchmarks/consensus_volume.py``.

Each of the 16 ``data`` positions of the 16 x 16 mesh is an AGENT holding
a whole granite-8b replica, split over the 16 ``model`` positions by the
placement table (:mod:`repro_torch.sharding.rules`). One round:

* ``fedavg_allreduce``: every leaf's shard averaged over the ``data``
  group (an all-reduce, f32);
* ``ring_consensus_f32`` / ``_bf16``: the port's distributed plan
  (:class:`repro_torch.core.engine.ConsensusEngine`, ``plan=
  "distributed"``) over the mesh's ``data`` axis on a ring of 16: each
  agent exchanges its replica with both ring neighbours, 2·b(W) per agent
  a round (each device its shard's share), in f32 or on the bf16 wire.

The round runs on ``meta`` tensors at each device's shard shapes, rank 0
of a ``FakeStore`` group of 256 ranks, and its c10d ops are recorded as
the dry run records them (:mod:`repro_torch.launch.hlo_analysis`). The
JAX package's shard_map-only ``ring_consensus_step`` is not ported: the
port's ring is its engine's distributed plan. Eq. (11) prices the same
rounds at the paper-calibrated radio parameters.

Run: ``PYTHONPATH=src python -m repro_torch.launch.consensus_volume``
"""
from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.core import energy
from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ConsensusEngine
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.hlo_analysis import StepRecorder, collective_bytes
from repro_torch.launch.steps import abstract_params
from repro_torch.sharding import rules
from repro_torch.sharding.parallel import local_shape

MODES = (("fedavg_allreduce", "fedavg", None),
         ("ring_consensus_f32", "ring", None),
         ("ring_consensus_bf16", "ring", "bf16"))


def shard_population(cfg, mesh) -> dict:
    """This device's shard of every leaf of one agent's replica, on
    ``meta``, f32, with the agent axis (one row) in front."""
    p_abs = abstract_params(cfg)
    specs = rules.param_specs(p_abs, cfg, mesh)
    model_only = {"model": dict(zip(mesh.mesh_dim_names,
                                    mesh.mesh.shape))["model"]}
    return {k: torch.empty((1,) + local_shape(tuple(v.shape), specs[k],
                                              model_only),
                           dtype=torch.float32, device="meta")
            for k, v in p_abs.items()}


def round_bytes(cfg, mesh, mode: str, codec=None) -> dict:
    """{collective kind: bytes} this device ships in one round of
    ``mode`` (``fedavg`` or ``ring``)."""
    params = shard_population(cfg, mesh)
    group = mesh.get_group("data")
    rec = StepRecorder()
    with rec.recording():
        if mode == "fedavg":
            for t in params.values():
                dist.all_reduce(t, group=group)
                t.div_(mesh.size(mesh.mesh_dim_names.index("data")))
        else:
            K = mesh.size(mesh.mesh_dim_names.index("data"))
            eng = ConsensusEngine(topo_lib.ring(K), codec=codec,
                                  mesh=mesh["data"], plan="distributed",
                                  axis_name="data")
            eng.step(params, eng.init_state(params), t=0)
    return {k: v for k, v in collective_bytes(rec.collectives).items() if v}


def run(cfg, mesh, *, verbose: bool = True) -> list:
    """One row per mode: bytes per device and per agent (the agent's
    devices: the ``model`` axis) a round, and the Eq.-(11) joules of the
    round over the ring of agents."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    K, m = shape["data"], shape.get("model", 1)
    p_cal = energy.paper_calibrated("fig3")
    model_bits = cfg.param_count() * 32.0       # the reference's b(W)
    ring = topo_lib.ring(K)
    rows = []
    for name, mode, codec in MODES:
        by_kind = round_bytes(cfg, mesh, mode, codec)
        per_device = sum(by_kind.values())
        joules = ring.round_comm_joules(p_cal, model_bits=model_bits,
                                        codec=codec)
        rows.append(dict(name=name, per_device_bytes=per_device,
                         per_agent_bytes=per_device * m, by_kind=by_kind,
                         joules=joules, agents=K, model_bits=model_bits))
        if verbose:
            print(f"{name:22s} {per_device / 1e9:8.3f} GB/device/round "
                  f"{per_device * m / 1e9:8.3f} GB/agent/round  "
                  f"{ {k: round(v / 1e9, 3) for k, v in by_kind.items()} }"
                  f"  Eq.(11) {joules:10.1f} J/round", flush=True)
    return rows


def reduced_rows(*, data: int = 4, model: int = 2, arch="granite-8b",
                 **overrides) -> list:
    """:func:`run` for reduced ``arch`` on a fake data x model group
    started and torn down here."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.launch.dryrun import fake_group

    fake_group(data * model)
    try:
        mesh = mesh_lib.make_host_mesh(data, model, device_type="cpu")
        cfg = dataclasses.replace(reduced(get_arch(arch)), **overrides)
        return run(cfg, mesh, verbose=False)
    finally:
        mesh_lib.destroy_local_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    args = ap.parse_args(argv)
    from repro_torch.launch.dryrun import fake_group

    cfg = get_arch(args.arch)
    fake_group(256)
    try:
        mesh = mesh_lib.make_production_mesh(device_type="cpu")
        n = cfg.param_count()
        print(f"{cfg.name} replica: {n / 1e9:.2f}B params "
              f"({n * 4 / 1e9:.1f} GB f32), 16 agents x 16 model shards")
        run(cfg, mesh)
    finally:
        mesh_lib.destroy_local_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
