"""The program layer's audits: the JAX package's program rules, as far as
they carry over to captured round programs.

Walks :func:`repro_torch.core.scanloop.registered_programs` after driving
small FL and MAML configurations through the real drivers and
``ConsensusEngine.scan_rounds`` (:func:`_tiny_drivers`), so the registry
holds the programs the drivers and engines actually build. A program is
CACHED when it is kept across calls: admitted to
``scanloop.cached_program`` (the drivers), or held by its engine
(``scan_rounds``; its ``cache_key`` family is ``"scan_rounds"``). Every
other program is built per call: the drivers' streaming and host-function
programs, and the launchers' (serving's prefill and decode, training's
step and federated round), which the audit runs at a reduced size
(:func:`_tiny_launchers`) beside the drivers. The meshed engines' programs
(the FL driver's cached round, ``scan_rounds``' held round and
``train_federated``'s round, their collectives inside) are driven on a
process group of world size 1 (:func:`_tiny_meshed`: gloo on the CPU,
NCCL on the card). JX1 and JX4 concern what may be CACHED; JX3 and JX5
hold for every program:

JX1  no function that failed the capture probe inside a CACHED program:
     a sampler or target that runs on the host before each replay
     (``ProgramRecord.host_fns``) must never be admitted to
     ``scanloop.cached_program`` — its probe consumed a stateful
     sampler's element, and a cache hit that skipped the probe would
     shift the stream between the first and later calls.
JX4  no streaming telemetry inside a CACHED program: a streaming round's
     rows are read and emitted to host sinks after each replay, so the
     drivers and engines build streaming programs per call and never
     keep them.
JX3  donation honoured (the card only): the replays of a captured
     program found every donated buffer at the address its
     graph writes, and whenever a caller handed back the carry of the
     last replay, that carry WAS those buffers
     (``ProgramRecord.in_place``): a carry handed out as a copy is copied
     back into the buffers every round, two generations of the
     population alive at once.
JX5  the async carry donated: a program whose arguments hold
     the ``AsyncState`` (per-agent clocks and per-lane wire ages,
     ``ProgramRecord.async_argnums``) lists them in ``donate_argnums``.

The JAX package's JX2 (decode before combine) reads a jaxpr: the port has
no jaxpr to read, and its int wire reaches the kernel as int8 lanes by
construction (``consensus._compressed_consensus_step``).
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding

LABEL = "src/repro_torch/core/scanloop.py"


def audit_programs(records) -> List[Finding]:
    """JX1, JX3, JX4 and JX5 over ``records``
    (:class:`repro_torch.core.scanloop.ProgramRecord`)."""
    findings: List[Finding] = []
    for rec in records:
        held = rec.cache_key is not None
        family = rec.cache_key[0] if held else None
        kept = ("held by its engine" if family == "scan_rounds"
                else "admitted to scanloop.cached_program")
        where = f"cache key {family!r}" if held else "built per call"
        if held and rec.host_fns:
            findings.append(Finding(
                "JX1", LABEL, 0,
                f"program {rec.name!r} ({where}) holds "
                f"{list(rec.host_fns)}, which failed the capture probe, "
                f"yet was {kept} — host round functions must be built per "
                "call", scope=rec.name))
        if held and rec.streaming:
            findings.append(Finding(
                "JX4", LABEL, 0,
                f"streaming-telemetry program {rec.name!r} ({where}) was "
                f"{kept} — streaming programs must be "
                "built per call", scope=rec.name))
        if rec.captured and rec.in_place is False:
            findings.append(Finding(
                "JX3", LABEL, 0,
                f"captured program {rec.name!r} ({where}): a "
                "replay found a donated buffer moved, or was handed its "
                "last carry as a copy of the buffers its graph writes — "
                "donation not honoured", scope=rec.name))
        undonated = sorted(set(rec.async_argnums) - set(rec.donate_argnums))
        if undonated:
            findings.append(Finding(
                "JX5", LABEL, 0,
                f"program {rec.name!r} ({where}): arguments "
                f"{undonated} hold the AsyncState (clock, ages) but "
                f"donate_argnums={tuple(rec.donate_argnums)} leaves them "
                "undonated — the async carry must be updated in place like "
                "the params", scope=rec.name))
    return findings


def _tiny_launchers(device) -> list:
    """The four launcher programs at a reduced size on ``device``, their
    records returned: ``serve`` of the hybrid (prefill and 3 decode
    steps: B3 and B4 on the card), ``train_standard`` of the hybrid (2
    steps, their backward) and ``train_federated`` of granite (int8+ef on
    the sparse plan, links fading and agents asleep, buffered telemetry,
    2 rounds at chunk 2). Their output is discarded."""
    import contextlib
    import io

    from repro_torch import telemetry as telemetry_lib
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import scanloop
    from repro_torch.core import topology as topo_lib
    from repro_torch.launch import serve, train

    small = dict(d_model=64, vocab=128)
    hybrid = reduced(get_arch("recurrentgemma-9b"), num_layers=3, **small)
    dense = reduced(get_arch("granite-8b"), **small)
    with scanloop.built_programs() as records, \
            contextlib.redirect_stdout(io.StringIO()):
        serve.serve(hybrid, batch=2, prompt_len=8, gen=4, device=device,
                    verbose=False)
        train.train_standard(hybrid, steps=2, batch=2, seq=8, lr=1e-3,
                             device=device)
        train.train_federated(
            dense, rounds=2, agents=2, tasks=1, local_steps=1, batch=1,
            seq=8, lr=1e-3, consensus_plan="sparse", codec="int8",
            dropout_p=0.3, availability=topo_lib.AgentProcess.bernoulli(
                0.7, seed=1), tau=2, chunk=2,
            telemetry=telemetry_lib.Telemetry(), device=device)
    return records


def _tiny_drivers(device):
    """Drive small FL and MAML configurations through the real drivers on
    ``device``: the int8 wire static and on an async engine with fading
    links, telemetry off, buffered (cached) and streaming (never cached),
    a host sampler (never cached) and ``maml_train_scan``; then
    ``scan_rounds`` on the same two engines, telemetry off, buffered and
    streaming (held by the engine, except streaming), twice each so the
    held programs replay from a handed-back carry. Returns the two
    engines: their programs live as long as they do."""
    import torch

    from repro_torch import telemetry as telemetry_lib
    from repro_torch.core import federated, maml
    from repro_torch.core import topology as topo_lib
    from repro_torch.core.engine import ConsensusEngine

    K, D = 4, 8

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return ((pred - batch["y"]) ** 2).mean()

    def sample_batches(generator, _t):
        x = torch.randn((K, 1, 4, D), generator=generator, device=device)
        return {"x": x, "y": x.sum(-1, keepdim=True)}

    host_x = torch.randn((K, 1, 4, D), generator=torch.Generator(
        device=device).manual_seed(3), device=device)

    def host_sampler(_generator, _t):
        return {"x": host_x, "y": host_x.sum(-1, keepdim=True)}

    def target_fn(stacked):
        # input-dependent on purpose: a constant target fails the probe,
        # and its program would never reach the cache this audit reads
        d = stacked["w"].mean()
        return d < -1e9, d

    stacked = {"w": torch.zeros((K, D, 1), device=device),
               "b": torch.zeros((K, 1), device=device)}
    engine = ConsensusEngine(topo_lib.ring(K), codec="int8", plan="sparse")
    async_engine = ConsensusEngine(
        topo_lib.ring(K), codec="int8", plan="sparse",
        graph=topo_lib.GraphProcess.dropout(0.3, seed=0),
        agents=topo_lib.AgentProcess.bernoulli(0.6, seed=0), tau=2)
    runs = ((engine, sample_batches, None),
            (async_engine, sample_batches, telemetry_lib.Telemetry()),
            (engine, sample_batches, telemetry_lib.Telemetry()),
            (engine, sample_batches,
             telemetry_lib.Telemetry(mode="streaming")),
            (engine, host_sampler, None))
    for eng, sampler, tel in runs:
        federated.run_fl_until_scan(
            loss_fn, stacked, sampler, eng, 0.1, target_fn=target_fn,
            max_rounds=2, chunk=2, telemetry=tel,
            generator=torch.Generator(device=device).manual_seed(0))
    mixed = {"w": torch.randn((K, D), generator=torch.Generator(
        device=device).manual_seed(4), device=device)}
    for eng in (engine, async_engine):
        for mode in (None, "buffered", "streaming"):
            for _ in range(2):
                eng.scan_rounds(
                    mixed, rounds=2,
                    generator=torch.Generator(device=device).manual_seed(1),
                    telemetry=(None if mode is None
                               else telemetry_lib.Telemetry(mode=mode)))

    def sample_tasks(generator, _t):
        x = torch.randn((2, 3, 4, D), generator=generator, device=device)
        q = torch.randn((2, 4, D), generator=generator, device=device)
        return ({"x": x, "y": x.sum(-1, keepdim=True)},
                {"x": q, "y": q.sum(-1, keepdim=True)})

    maml.maml_train_scan(
        loss_fn, {"w": torch.zeros((D, 1), device=device),
                  "b": torch.zeros((1,), device=device)},
        sample_tasks, rounds=2, inner_lr=0.1, outer_lr=0.1, inner_steps=3,
        chunk=2, generator=torch.Generator(device=device).manual_seed(0))
    return engine, async_engine


def _tiny_meshed(device) -> list:
    """The meshed round programs on ``device``, their records returned: on
    a group of world size 1 started here (gloo on the CPU, NCCL on the
    card; a group already live is used as it is, two agents a rank), a
    sharded int8 engine with fading links and sleeping agents runs
    ``run_fl_until_scan`` (telemetry off, buffered and streaming, and a
    host sampler) and ``scan_rounds`` twice a telemetry mode, and a
    reduced granite trains two federated rounds on the mesh. Their cached
    programs are evicted before a group started here is destroyed."""
    import contextlib
    import io
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import telemetry as telemetry_lib
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import federated, scanloop
    from repro_torch.core import topology as topo_lib
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.launch import mesh as mesh_lib, train

    cuda = torch.device(device).type == "cuda"
    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if own:
            mesh_lib.init_local_group(0, 1, os.path.join(tmp, "store"),
                                      backend="nccl" if cuda else "gloo")
        try:
            mesh = mesh_lib.make_agent_mesh(
                device_type="cuda" if cuda else "cpu")
            world = dist.get_world_size()
            K, D = 2 * world, 8
            eng = ConsensusEngine(
                topo_lib.ring(K), codec="int8", plan="sharded", mesh=mesh,
                graph=topo_lib.GraphProcess.dropout(0.3, seed=0),
                agents=topo_lib.AgentProcess.bernoulli(0.6, seed=0), tau=2)
            rows = eng.local_rows

            def loss_fn(p, batch):
                return ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()

            def sample_batches(generator, _t):
                x = torch.randn((K, 1, 4, D), generator=generator,
                                device=device)
                return {"x": x, "y": x.sum(-1, keepdim=True)}

            host_x = torch.ones((K, 1, 4, D), device=device)

            def host_sampler(_generator, _t):
                return {"x": host_x, "y": host_x.sum(-1, keepdim=True)}

            def target_fn(stacked):
                d = stacked["w"].mean()
                return d < -1e9, d

            mine = {"w": torch.zeros((rows.stop - rows.start, D, 1),
                                     device=device)}
            with scanloop.built_programs() as records, \
                    contextlib.redirect_stdout(io.StringIO()):
                for sampler, mode in ((sample_batches, None),
                                      (sample_batches, "buffered"),
                                      (sample_batches, "streaming"),
                                      (host_sampler, None)):
                    federated.run_fl_until_scan(
                        loss_fn, mine, sampler, eng, 0.1,
                        target_fn=target_fn, max_rounds=2, chunk=2,
                        telemetry=(None if mode is None
                                   else telemetry_lib.Telemetry(mode=mode)),
                        generator=torch.Generator(
                            device=device).manual_seed(0))
                flat = {"w": mine["w"][:, :, 0]}
                for mode in (None, "buffered", "streaming"):
                    for _ in range(2):
                        eng.scan_rounds(
                            flat, rounds=2,
                            generator=torch.Generator(
                                device=device).manual_seed(1),
                            telemetry=(None if mode is None else
                                       telemetry_lib.Telemetry(mode=mode)))
                train.train_federated(
                    reduced(get_arch("granite-8b"), d_model=64, vocab=128),
                    rounds=2, agents=2 * world, tasks=1, local_steps=1,
                    batch=1, seq=8, lr=1e-3, consensus_plan="sharded",
                    codec="int8", mesh=mesh, device=device)
            scanloop.evict_programs(records)
            return records
        finally:
            if own:
                mesh_lib.destroy_local_group()


def run_program_audit(device="cpu") -> List[Finding]:
    """The programs layer: :func:`_tiny_drivers`, :func:`_tiny_launchers`
    and :func:`_tiny_meshed` on ``device``, then :func:`audit_programs`
    over every live program and the records of those that died with
    their call or group."""
    from repro_torch.core import scanloop
    engines = _tiny_drivers(device)        # noqa: F841 (keeps programs)
    built = _tiny_launchers(device) + _tiny_meshed(device)
    live = scanloop.registered_programs()
    ids = {id(r) for r in live}
    return audit_programs(live + [r for r in built if id(r) not in ids])
