"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Phases (any failure exits non-zero; nothing is caught):

1. env        — torch/CUDA versions, the card's name and power limit.
2. build      — compile the CUDA kernels from ``src/repro_torch/
                kernels/csrc`` (one nvcc per source, in parallel: the four
                forward kernels, B3′ beside B3, B4′ in its own source),
                timed as set-up; ptxas's registers, static shared memory
                and spills of each kernel, and B4′'s dynamic shared memory
                a block (the f32 SIMT and the bf16 tensor-core kernels).
3. analysis   — ``python -m repro_torch.analysis --strict --baseline
                src/repro_torch/analysis/baseline.json --device cuda``
                (``--layer all``) in process on this checkout: the source
                rules, and the cost model with its engine rounds on the
                card (C2 at K = 12 and at K = 256 paper-DQN width on the
                dense plan; C1b on every plan x codec at K = 8 and on the
                dense and sparse plans at K = 256 paper-DQN width, where
                B1 and B2 must launch) and C1a/C3 on a gloo group of 8
                CPU processes it spawns; a finding the committed baseline
                does not hold fails the smoke. Its wall is printed.
4. kernels    — each kernel against its plain PyTorch version on the card,
                on full-width paper-DQN params stacked over K = 256 agents
                (ring and small-world graphs; codecs None and bf16 for the
                f32/decoded kernel, int8 / int4 / int8:b64 for the fused
                int-wire kernel) and at the case study's own shapes (one
                2-robot cluster); then kernel, plain-version and library
                times and the memory bound at the largest leaf (fc1.w).
5. engine     — ``ConsensusEngine(ring(256), plan="auto")`` resolves to the
                sparse plan and agrees with the dense plan.
6. casestudy  — the paper's MAML + consensus-FL case study, forced onto the
                sparse plan, with codec int8 and with no codec; each run
                is counted from 0 and must launch its own kernel once per
                leaf per FL round, and the other kernel never.
7. dynamic    — the same path on fading links and sleeping agents: the
                engine at K = 256 (paper-DQN stacks, ring and small-world,
                codecs None / int8 / int8:b64 / bf16, links fading, agents
                sleeping, both): 4 rounds of ``scan_rounds`` on the sparse
                plan equal its steps bit for bit, and each round the dense
                plan from the same state within the engine gate; the
                always-on reduction and a round in which every agent
                sleeps, bit for bit; masks drawn on the card equal the
                CPU's; B1/B2 on σ tables with zeros and λ^age weights equal
                their plain versions; the case study with dropout_p = 0.3
                and robots awake with p = 0.75 (τ = 2, λ = 0.9), codecs
                int8 and None: launches as in ``casestudy``, the bill of the
                wires the card delivered == the host replay and no more
                than the static bill, E_total = Eq. (12) with the measured
                joules; a profile of one dynamic FL round and the launches
                its draws add.
8. drivers    — per-round Eq.-(11) telemetry and the chunked protocol
                drivers at full width (paper-DQN × K = 256, small_world(k=4),
                sparse plan, links fading with p = 0.3, agents awake with
                p = 0.7, τ = 2, λ = 0.9): (a) 8 rounds of ``scan_rounds``
                with buffered telemetry on the int8 wire equal the
                telemetry-off rounds bit for bit, every row's link and
                per-agent counts and the summed joules equal the host replay
                (``==``), B1 launches 10 × 8 either way; off / buffered /
                streaming walls and the kernels a row adds; at the default
                byte cap these programs run eagerly under the byte rule
                (asserted); with the cap lifted the engine's captured round
                program, off and buffered, two calls each, == the same
                rounds under ``scanloop.uncaptured()`` (params, EF state,
                rows, B1 10 × 8 inside the graphs); (b)
                ``run_fl_until_scan`` at chunk 8 against ``run_fl_until``
                (f32 wire, B2) on a regression pull toward seeded targets,
                the hit mid-chunk: params, t_i, history and the live rows bit
                for bit, B2 launches 10 × rounds computed; (c) the ``dynamic``
                int8 case study again with streaming telemetry into
                ``build/telemetry.jsonl``: results, params and launches equal
                the telemetry-off run, per-task streamed joules == the
                post-hoc bill, t_i events per task, the log passes the
                schema; (d) ``MTLProtocol`` with the paper-DQN Q-network
                regressed on one-step rewards (2-robot clusters, t0 = 5,
                max_rounds 16; dense at K = 2, so no kernel launches).
9. paper      — the paper's experiments at full paper-DQN width on the
                sparse plan, codec None (B2 carries every combine): (a)
                ``CaseStudy.run`` at ``r_target=-1e9``, t0 2, max_rounds 4,
                at chunk 1 and chunk 4: every task's t_i, history and
                adapted params ``==``, B2 launches 10 × rounds computed (60
                / 240), B1 none; (b) the Fig. 4 sweep reduced to 1 seed,
                grid (0, 2, 4), max_rounds 8: energies ``==`` recomputed
                from the mean t_i, and grid (4,) alone gives the same t_i
                at t0 = 4; (c) the MAML stage alone: ms per meta round
                (median of 7), kernels per meta round and the busy share;
                (d) the twin of ``examples/async_fleet.py`` (int8, sparse,
                B1): rows == the host replay, joules == the bill; each
                fleet's ``scan_rounds`` replays its captured round program,
                == the same fleets under ``uncaptured()`` (params, rows,
                launches).
9b. programs  — the compiled round programs (CUDA graphs,
                ``core/scanloop.py``): (a) the case study's meta and FL
                programs (dense plan, K = 2) captured == the same runs
                under ``scanloop.uncaptured()`` on the int8 and f32 wires,
                static / fading / sleeping, chunks 1 and 8 (meta and FL
                params, codec state, AsyncState, t_i, history, generators,
                telemetry rows, delivered masks); (b) ``run_fl_until_scan``
                at paper-DQN x K = 256 (sparse) the same, with the byte cap
                lifted (each case's program dropped after it), B1/B2 10 a
                round inside the graphs, counted through the replays; every
                main-path program captured or eager under the byte rule
                (and saying so), none with a host function, some cached;
                (e) at K = 256 (cap lifted) the variants captured mid-run
                the same: ``eval_every=2`` (skip and evaluate graphs) and a
                target that reads the host (``update`` / ``commit`` graphs,
                never cached); (c) captured against eager: wall ms a round
                (median of 3), kernels a round and busy share
                (``torch.profiler``), B1/B2 kernels counted by name in the
                traces == the counters == the eager trace, peak memory,
                captures, replays, capture s, launches a replay and held
                bytes of the case-study FL round, the meta round, the
                K = 256 driver (int8 and f32) and ``scan_rounds`` (int8)
                with the cache's byte cap lifted, and the async fleet's
                ``scan_rounds`` (K = 8); then the int8 driver at the default
                cap, whose program must stay cached under the byte rule,
                never captured, every timed call a hit, its ms a round
                printed beside the eager row's; (d) a refused capture
                raises naming the program and the op. Every phase header
                prints the device memory, the captured programs alive, the
                bytes the program cache and the engines' ``scan_rounds``
                programs hold, and how many programs are eager under the
                byte rule; nothing clears the cache between phases.
10. mesh      — the sharded and distributed plans: (a) B1/B2 in their
                source form (a block of owned rows mixing from the
                gathered population or wire; one agent from M received
                rows) against their plain versions at K = 16384, N = 2048,
                timed beside the population form; (b) ``sharded`` (4
                blocks) == ``sparse`` bit for bit at K = 4096 and 16384 on
                ring, N = 2048, codecs None / int8 / int8:b64, static,
                fading (p = 0.3) and async (p_active 0.7, τ = 2, λ = 0.9),
                launches exactly 4 per leaf per round, and one static round
                of each timed; (c) ``distributed`` against ``sparse`` at
                K = 256 small_world(k=4), fc1.w width, within the engine
                gate (int8: the int-wire tolerance), one launch per leaf
                per round, its slot masks == the CPU's, timed; (d) an NCCL
                process group of world size 1: the mesh path == the
                one-process path for both plans on a masked round; (e) one
                masked sharded round at K = 16384 adds at most 4x the
                population's f32 bytes to the peak allocation; (f)
                ``repro_torch.launch.consensus_scale --smoke`` with its
                gates; (g) in another NCCL group of world size 1, the FL
                driver on the meshed engine at full width (paper-DQN x
                K = 256, small_world(k=4), sharded with 1 block, links
                fading with p = 0.3): ``multichip.fl_run``, the gloo
                tests' FL case (``run_fl_until_scan`` at chunk 8 with
                buffered telemetry and a generator), on the int8 (B1)
                and f32 (B2) wires, == the same run without ``mesh=``
                (params, t_i, history, generator, rows; disagreement
                within its tolerance), B1 / B2 exactly 10 x the rounds
                computed, the observer collectives' bytes, walls beside
                the run without a mesh; with the byte cap lifted its
                cached program captured (collectives inside), replayed
                on the hit and == ``uncaptured()``, at the default cap
                eager by the byte rule, a recorded all-replay run C3
                clean; (h) ``scan_rounds`` on the meshed engine, buffered
                telemetry, K = 8 and K = 256 (cap lifted), its held
                program captured == ``uncaptured()`` == without a mesh,
                ms a round, held bytes, the collectives' device events;
                (i) ``train_federated(mesh=)`` at granite-8b width, 2
                layers, 4 agents, codec None: captured == uncaptured ==
                without ``mesh=``, the recorded collectives ==, C3 with
                the logged loss's broadcast, its round program timed
                and its peaks. As in (d), one rank exchanges nothing:
                multi-rank runs are held by the gloo tests
                (tests/test_torch_mesh_fl.py,
                tests/test_torch_mesh_programs.py) alone.
11. profile   — host wall and device kernel time of one case-study FL
                round (``torch.profiler``), the device's busy share.
12. lm_kernels — the RG-LRU scan and flash-attention kernels against their
                plain versions at recurrentgemma-9b's serving shapes (bf16
                attention at scores of std 1 and of std 20, which the
                softcap bends; a ragged bf16 case with a window that cuts
                kv tiles; and a ragged f32 case), then kernel,
                plain-version and library (SDPA at softcap 0) times, each
                bound, B4's achieved TFLOP/s, and ptxas's registers and
                spills of the two sources; then B4 at h2o-danube-3-4b's
                (GQA 32/8, hd 120, window 4096) and qwen2-moe-a2.7b's (MHA
                16 x 128, causal) prefill shapes, bf16: against its plain
                version under the rounding gate, and kernel, plain, SDPA
                times and the bound at batch 4. Every time is the median
                of 20 calls. Last, B4's backward memory (ROADMAP C11): the
                peak ``max_memory_allocated`` above the inputs of one
                forward and backward at q = k = v (1, 4096, 4, 64) f32,
                causal, against the JAX package's compiled gradient
                temporaries at that shape (its chunked scan's 804.2 MB and
                its einsum path's 1350.6 MB, on the CPU): the ratio k to
                the chunked scan must stay within 3. It prints on a line
                of its own, outside the ``kernels`` line, which holds only
                this run's measurements.
13. serve     — ``repro_torch.launch.serve`` on full-width, full-depth
                recurrentgemma-9b (random weights): 4 prompts of 4096
                tokens, 32 greedy tokens; each prefill must launch the scan
                26 and the attention kernel 12 times, decode neither. The
                prefill and decode steps are ``serve``'s two launcher
                programs, each captured once on its first call (at the
                default byte cap; the prefill's graph, never replayed in
                the call, is dropped before the decode's capture) and the
                decode replayed every later token; the same call under
                ``scanloop.uncaptured()`` gives the same tokens, last
                logits and final caches bit for bit and the same launches
                by phase, its times beside the captured ones. Then a
                profile of one prefill and 4 decode steps, and of a replay
                of the prefill program and 4 of the decode program (host
                wall, kernels, device busy share, B3/B4's share of the
                prefill; capture seconds, held bytes, peak allocated and
                reserved); prefill + 1 decode step against the full
                forward at full width and one pattern period (3 layers).
14. serve_lm  — the transformer family: (a) h2o-danube-3-4b and
                qwen2-moe-a2.7b served at full width and depth as in
                ``serve`` (B4 24 times per prefill, never in decode, B3
                never; counted params == ``param_count()`` plus the shared
                gate and q/k norms it leaves out; peak memory; the
                programs captured ``==`` uncaptured), each profiled like
                ``serve``, and one qwen2-moe MoE layer timed
                alone at the prefill's and a decode step's token counts
                (the dispatch's share); (b) prefill + 1 decode step against
                the full forward at full width, 4 layers, a 4200-token
                prompt (danube's circular cache wraps; qwen2-moe in f32
                at capacity factor 8.0); (c) stablelm-3b, granite-8b,
                deepseek-7b, mixtral-8x7b and chameleon-34b at full width
                and 2 layers, a 1 x 4096 prefill each (B4 twice).
15. train_lm  — LM training through the kernels: (a) B4 with its gradient
                at granite-8b's training shape (q (4, 512, 32, 128), kv 8
                heads, causal) in f32 and bf16: the forward against the
                plain version under its gate, dq/dk/dv (B4′) against
                autograd through the plain version on the card (f32 within
                2e-4 of each gradient's max, bf16 within 2^-6 of it: two
                routes, each within one rounding), one B4 and one B4′
                launch, also under ``torch.func.vmap(grad)`` over 3
                batches; B4′ alone against its plain version (f32 within
                1e-4, bf16 within 2^-7), deterministic, one launch a call,
                at granite's, the hybrid's local attention's (MQA, hd 256,
                window 2048, softcap 30), danube's and stablelm's training
                shapes in f32 and bf16, with kernel, plain, SDPA-backward
                and bound ms, achieved TFLOP/s of its 10·hd work and its
                factor against SDPA's backward; each profiled training
                step prints B4′'s device time beside its bf16 CUDA-core
                figure (``B4P_SIMT_DEVICE_MS``); B3 at (2, 256, 512) with
                its gradient (B3′: ``==`` autograd through the plain
                version) and B3′ alone
                ``==`` its plain version in f32 and bf16 (one launch a
                call), and at ``B3P_EXTRA_SHAPES`` (T and W ragged over
                two laps of its cluster and a third, no TMA; exactly two
                laps at the hybrid's width); forward and
                forward+backward times (kernel, plain version, SDPA); (b)
                ``train_standard``
                on granite-8b at full width and 2 layers (batch 4 x 512, 5
                Adam steps): finite losses, B4 2·L launches a step (remat)
                and B4′ L,
                the step program captured once and replayed, the same run
                under ``uncaptured()`` ``==`` (params, Adam state, losses,
                grad norms), step 1's loss and gradient norm against the
                same step with the attention's plain version, ms per step
                captured and eager, peak memory, a profiled step, eager
                and replayed; (c) ``train_federated`` at the
                same width (4 agents, 2 tasks, 2 local steps, batch 2 x
                256, 3 rounds, sparse plan): B2 12 launches a round with
                codec None, bf16 consensus and ``auto`` (bf16+ef), B1 12
                with int8+ef; chunk 3 == chunk 1 (params, losses, error
                feedback); links fading (p 0.3) and agents awake with p
                0.7 (τ 2): buffered telemetry == off bit for bit, every
                row's joules == the host replay; the Eq.-(11) estimate ==
                the host formula; 2 rounds at chunk 2 with buffered
                telemetry, codec None and int8+ef, the round program
                captured once == uncaptured (population, codec state,
                losses, rows, launches); sleeping agents held bit for bit;
                ms, kernels and busy share per round of the round
                program, eager (under ``uncaptured()``) and captured, and
                peak memory; (d) a
                ``CheckpointManager`` round trip of the population, bit
                for bit; (e) ``python -m repro_torch.launch.train
                --reduced`` federated and standard, exit 0.
16. zoo       — the rest of the LM zoo: (a) B4 at whisper-large-v3's
                shapes, bf16, against its plain version under the rounding
                gate: served (batch 4), the encoder (q, kv (4, 1500, 20,
                64), no mask) and a 64-token prompt's cross-attention;
                trained (batch 2), the encoder, the 448-token decoder's
                cross-attention over 1500 frames and its causal
                self-attention (448 x 448), with gradients (B4′, within
                2^-6 of autograd through the plain version); kernel, plain
                and SDPA times and the operation bound; B4′ alone at the
                three trained shapes, f32 and bf16; B3 with its gradient
                at the hybrid's training shape (2, 512, 4096) f32 and B3′
                alone there in f32 and bf16, with its device time alone
                (the profiler's) warm and with the L2 evicted before each
                call, beside the byte bound;
                (b) whisper-large-v3 served at full width and depth (32 +
                32 layers, 4 x 1500 stub frames, a 64-token prompt, 32
                tokens): B4 exactly 96 per prefill (32 encoder, 32 decoder
                self, 32 cross) and 0 per decode step, counted params ==
                the JAX package's count, peak memory, the programs
                captured ``==`` uncaptured, a profile of the prefill and 4
                decode steps and of the programs' replays (busy share,
                capture seconds), decode against
                the full forward at 4 + 4 layers, in f32 per logit and in
                bf16 within 0.06 (1 + rms of the logits), with the f32
                forward as the witness of bf16's rounding; (c) the same
                for xlstm-125m (4 x 512 prompt, 32 tokens; no kernel: B4
                0), decode against the forward at 3 layers and a 300-token
                prompt; (d) ``train_standard`` on whisper at full depth
                (batch 2 x 448 decoder tokens + 1500 frames, 5 Adam steps,
                remat): B4 exactly 192 and B4′ 96 a step, ms a step, peak,
                one step profiled, step 1 against the same step through
                B4's plain version (loss and gradient norm); (e)
                xlstm-125m ``train_standard`` (batch 4 x 256, 5 steps) and
                ``train_federated`` (clusters(2, 2), 1 local step of 2 x
                64, 2 rounds, sparse plan, codec None and int8+ef, buffered
                telemetry): B2 / B1 exactly 171 (the JAX leaves) a round,
                the Eq.-(11) estimate == the host formula, every row's
                joules == the host replay; (f) recurrentgemma-9b at full
                width and 3 layers (one pattern period): ``train_standard``
                (batch 2 x 512, 3 steps) with B3 4, B4 2, B3′ 2 and B4′ 1
                a step (forward and remat recompute, and their backward
                kernels: all inside the captured step), ``==`` the same
                steps under ``uncaptured()``, one step profiled (eager and
                replayed), step 1 against B3's and B4's plain versions,
                ``train_federated`` (2 agents, 1 local step of 2 x 256, 2
                rounds, codec None): B3, B4, B3′, B4′ and B2 (42 leaves a
                round) exact.
17. mesh_lm   — the LM zoo on a data x model mesh, in an NCCL group of
                world size 1 (``make_host_mesh(1, 1)``; the multi-rank
                splits are held to the JAX package and to the one-process
                port by the gloo tests on the CPU,
                tests/test_torch_sharding.py): (a) granite-8b at full
                width and 2 layers, one ``train_standard``-style step
                (batch 4 x 512) of ``make_train_step`` with the mesh and
                the params placed by the table against the same builder
                without a mesh: loss and gradient norm within the
                ``train_lm`` gates, B4 2·L launches each; (b)
                qwen2-moe-a2.7b at full width and 2 layers in f32, a 1 x
                4096 prefill with the MoE routed per data shard
                (``moe_block`` given the mesh's view, both layers) against
                the same prefill without a mesh:
                last-position logits within the f32 serve gate (abs + rel
                per logit), B4 2 launches each; the times of each; (c)
                recurrentgemma-9b at full width and 3 layers,
                whisper-large-v3 and xlstm-125m at full size, each one
                training step with the mesh against the same step without
                it (loss and gradient norm ``==``) and a prefill plus 4
                decode steps from caches placed by the table against the
                same serving without it (max |d| 0), B3 and B4 launching
                as often on both paths (tests/test_torch_sharding_
                families.py holds the multi-rank splits on the CPU).
18. dryrun    — (a) ``python -m repro_torch.launch.dryrun --arch
                granite-8b --shape train_4k`` (the 16 x 16 production
                mesh on a fake group, meta tensors, H100 roofline) in a
                subprocess, its report printed; (b) the same code's
                prediction of (a)'s granite step (2 layers, 4 x 512, 1 x 1)
                against the step measured on the card: predicted peak
                within [0.8, 1.25] x ``max_memory_allocated``, and the
                roofline step time at most the median of 3 measured steps
                (a faster step means a wrong count); the ratio and the
                joules a step at the card's power limit.

The line before the last is the kernels JSON; the last is the ``ok`` line.

Run:  python3 chip_smoke.py
"""
import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: H100 SXM rates of the bound column, set from
#: ``repro_torch.core.energy.H100_SXM`` (data sheet) by :func:`set_rates`:
#: device memory, float32 outside tensor cores, bf16 dense tensor cores
HBM_BYTES_PER_S = F32_FLOPS_PER_S = BF16_FLOPS_PER_S = None
F32_TOL = 1e-6                  # kernel vs plain: same ops, same order
BF16_TOL = 0.0                  # ... and the same final rounding
K_POP = 256
DEVICE = "cuda"
#: the port's kernel wrappers (``repro_torch.kernels.ops``), in table order
KERNELS = ("quant_consensus_pop", "consensus_update_pop", "rglru_scan",
           "flash_attention", "rglru_scan_backward",
           "flash_attention_backward")
ARCH = "recurrentgemma-9b"
SERVE = dict(batch=4, prompt_len=4096, gen=32)
#: the transformer family served at full width and depth (``serve_lm``)
LM_ARCHS = ("h2o-danube-3-4b", "qwen2-moe-a2.7b")
#: the other transformer archs, at full width and two layers
TWO_LAYER_ARCHS = ("stablelm-3b", "granite-8b", "deepseek-7b",
                   "mixtral-8x7b", "chameleon-34b")
#: decode vs full forward of the transformers: layers, batch, prompt
#: (longer than danube's window of 4096, so its circular cache wraps)
LM_DECODE_CHECK = dict(layers=4, batch=2, prompt=4200)
B3_TOL = 1e-6                   # max |kernel - plain| / max(1, |plain|)
B4_F32_TOL = 2e-3               # abs + rel (the JAX package's own gate)
# bf16: the plain version rounds each probability to bf16 (relative error
# <= 2^-8) before P·V, the kernel carries them as two bf16 terms (within
# 2^-16), and both round the output to bf16 (<= 1 ulp apart, ulp <= 2^-7
# |x|). So
#   |kernel - plain| <= 2^-7 |plain| + 2^-8 Σ_t p_t |v_t|,
# gated with that and 1e-5 for f32 summation order
B4_BF16_REL, B4_BF16_PV, B4_BF16_ABS = 2.0 ** -7, 2.0 ** -8, 1e-5
DECODE_TOL = 6e-2               # decode vs full forward (test_arch_smoke)
#: training (``train_lm``): granite-8b at full width, depth cut to 2 layers
#: (8.25 B params with Adam's 16 B/param does not fit 80 GB)
TRAIN_ARCH, TRAIN_LAYERS = "granite-8b", 2
TRAIN_STD = dict(steps=5, batch=4, seq=512, lr=1e-3)
TRAIN_FED = dict(rounds=3, agents=4, tasks=2, local_steps=2, batch=2,
                 seq=256, lr=1e-3)
#: B4 / B3 gradient vs autograd through the plain version, of each
#: gradient's largest entry: f32, and bf16 (one rounding)
GRAD_F32_REL, GRAD_BF16_REL = 1e-4, 2.0 ** -7
#: B4′ against autograd through the plain forward, another route to the
#: same gradient: each route within one rounding of the exact gradient
#: (the CPU tests hold both to the f64 one), so within two of each other
GRAD_ROUTE_FACTOR = 2
#: B4′ at the training paths' shapes (B, S, H, K, T, hd) and masks:
#: granite-8b (train_lm); recurrentgemma-9b's local attention (MQA, hd
#: 256, window 2048, softcap 30; the zoo's hybrid); danube's (hd 120,
#: window 4096) and stablelm's (hd 80, MHA) steps at granite's batch;
#: whisper's three are held in ``check_b4_whisper_shapes``
B4_BWD_SHAPES = {
    "granite-8b": ((4, 512, 32, 8, 512, 128),
                   dict(causal=True, window=0, softcap=0.0)),
    "recurrentgemma-9b local": ((2, 512, 16, 1, 512, 256),
                                dict(causal=True, window=2048,
                                     softcap=30.0)),
    "h2o-danube-3-4b": ((4, 512, 32, 8, 512, 120),
                        dict(causal=True, window=4096, softcap=0.0)),
    "stablelm-3b": ((4, 512, 32, 32, 512, 80),
                    dict(causal=True, window=0, softcap=0.0)),
}
#: step 1 with the kernels vs with the attention's plain version: the bf16
#: attention outputs differ by their rounding, averaged over 2048 tokens
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-2, 2e-2


#: the zoo (``zoo``): whisper-large-v3 and xlstm-125m at full width and
#: depth; recurrentgemma-9b trained at full width, depth cut to one
#: pattern period (2 RG-LRU + 1 local attention: 2.69 B params, 2.10 B of
#: them the embed and unembed)
WHISPER, XLSTM, HYBRID_LAYERS = "whisper-large-v3", "xlstm-125m", 3
WHISPER_SERVE = dict(batch=4, prompt_len=64, gen=32)
#: xLSTM's prompt cut to 512 and its federated runs to 2 rounds of 64
#: tokens in PR 29 (its host-bound sLSTM loop and first calls dominate
#: ``zoo``), for the time B3′ / B4′'s checks add
XLSTM_SERVE = dict(batch=4, prompt_len=512, gen=32)
WHISPER_TRAIN = dict(steps=5, batch=2, seq=448, lr=1e-3)
XLSTM_TRAIN = dict(steps=5, batch=4, seq=256, lr=1e-3)
#: one local step a round: the sLSTM loop's first call
#: and capture dominate the phase's wall
XLSTM_FED = dict(rounds=2, agents=4, tasks=2, local_steps=1, batch=2,
                 seq=64, lr=1e-3)
HYBRID_TRAIN = dict(steps=3, batch=2, seq=512, lr=1e-3)
HYBRID_FED = dict(rounds=2, agents=2, tasks=1, local_steps=1, batch=2,
                  seq=256, lr=1e-3)
#: the JAX package's ``count_params`` at full size (``jax.eval_shape``;
#: the CPU tests hold the port's count to it); ``param_count()`` differs
#: for these two families, as the reference's formula does (ROADMAP C9)
ZOO_COUNTED = {WHISPER: 1_535_219_200, XLSTM: 138_047_296}
#: decode vs full forward at a cut depth: layers (whisper: each stack),
#: batch, prompt (xLSTM's 300 is not a multiple of the 256-step chunk),
#: and (dtype, rms_gate) of each run. Whisper's logits are tied to an
#: embedding of std 1, so they are ~36x the unit scale (rms ~ sqrt(d)·
#: rms(h)): a logit near 100 has a bf16 ulp of 0.5, and the prefill's
#: kernel against decode's plain attention parts the two bf16 paths by
#: ~1 (11x the per-logit 0.06 + 0.06|b| gate at 4 + 4 layers on the
#: H100). So its served bf16 path is held to the same 0.06 scaled to the
#: logits, 0.06 (1 + rms), and its f32 path to the per-logit gate; the
#: f32 forward of the same weights is the witness that the bf16 gap is
#: bf16's rounding (``zoo_serve``)
ZOO_DECODE_CHECK = {WHISPER: dict(layers=4, batch=2, prompt=64,
                                  runs=(("float32", False),
                                        ("bfloat16", True))),
                    XLSTM: dict(layers=3, batch=2, prompt=300,
                                runs=(("bfloat16", False),))}


T_START = time.perf_counter()
#: the card's name and power limit (``nvidia-smi``), printed beside the
#: numbers of the phases that read it
SMI = "card not read yet"


def phase(name):
    """Print a phase header with the seconds since the script started,
    then (once the card is in use) the device memory held, the captured
    round programs alive and the bytes the program cache holds: the
    earlier phases' programs stay cached, as in a user's process."""
    print(f"\n== {name} == (t = {time.perf_counter() - T_START:.1f} s)",
          flush=True)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        from repro_torch.core import scanloop
        live = [r for r in scanloop.registered_programs() if r.captured]
        stats = scanloop.cache_stats()
        print(f"memory before {name}: allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, reserved "
              f"{torch.cuda.memory_reserved() / 1e9:.3f} GB; {len(live)} "
              f"captured programs alive holding "
              f"{sum(r.held_bytes for r in live) / 1e9:.3f} GB, "
              f"{stats['size']} cached holding "
              f"{stats['held_bytes'] / 1e9:.3f} GB, engines' scan_rounds "
              f"programs holding {stats['scan_rounds_held_bytes'] / 1e9:.3f}"
              f" GB, {stats['eager_by_byte_rule']} eager by the byte rule",
              flush=True)


def stamp(what):
    """Print the seconds since the script started after a step."""
    print(f"{what} done at t = {time.perf_counter() - T_START:.1f} s",
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, iters=20, warmup=2):
    """Median device time of one call, by CUDA events around each call.
    The events are recorded back to back with one synchronize at the end,
    so the card does not sit idle between a start event and its call
    while the host launches it."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def set_rates():
    """The bound column's rates from the port's H100 SXM table."""
    from repro_torch.core.energy import H100_SXM

    global HBM_BYTES_PER_S, F32_FLOPS_PER_S, BF16_FLOPS_PER_S
    HBM_BYTES_PER_S = H100_SXM["hbm_bw"]
    F32_FLOPS_PER_S = H100_SXM["peak_flops_f32"]
    BF16_FLOPS_PER_S = H100_SXM["peak_flops_bf16"]


def bound(nbytes, flops, flops_per_s=None):
    """(least time in ms, what bounds it) for the given bytes and flops
    (float32 rate unless ``flops_per_s`` is given)."""
    flops_per_s = flops_per_s or F32_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def same_work(name, got, old):
    """A kernel's (bytes, flops) from ``repro_torch.kernels.work`` must be
    the smoke's earlier inline count of the same call."""
    if tuple(int(x) for x in got) != tuple(int(x) for x in old):
        fail(f"{name}: kernels/work.py counts {got}, the smoke's earlier "
             f"formula {old}")
    return got


def ptxas_summary(name):
    """ptxas's registers, static shared memory and spills for each kernel
    of one source, by kernel (its name, element type and int template
    arguments read off the mangled name)."""
    import re
    from repro_torch.kernels import build
    log = build.BUILD_LOGS.get(name)
    if log is None:
        return "not built in this run"
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            # <length><name> pairs of the mangled name: its *_kernel
            ident = [mangled[d.end():d.end() + int(d.group()[i:])]
                     for d in re.finditer(r"\d+", mangled)
                     for i in range(len(d.group()))]
            ident = [x for x in ident if "_kernel" in x
                     and re.fullmatch(r"[A-Za-z_]\w*", x)]
            name = ident[-1] if ident else mangled
            # the tensor-core (*_tc) kernels are bf16 whatever they take
            bf16 = "bfloat16" in mangled or name.endswith("_tc")
            args = ["bf16" if bf16 else "f32"] + \
                re.findall(r"L[ib](\d+)E", mangled)
            cur = f"{name}<{','.join(args)}>"
            out.append([cur])
        elif cur and ("registers" in ln or "spill" in ln or "smem" in ln):
            out[-1].append(ln.split(":", 1)[-1].strip())
    return " | ".join(" ".join(x) for x in out) or log[-500:]


def launch_counts():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import ops
    return {n: getattr(ops, n).launches for n in KERNELS}


def zero_counts():
    from repro_torch.kernels import ops
    for n in KERNELS:
        getattr(ops, n).launches = 0


def stacked_params(cfg, K, generator):
    from repro_torch.models import dqn as qmodel
    agents = [qmodel.init(cfg, generator=generator, device=DEVICE)
              for _ in range(K)]
    return {k: torch.stack([a[k] for a in agents]) for k in agents[0]}


def check_kernels(cfg, generator):
    from repro_torch.comms import codecs
    from repro_torch.core import consensus, topology
    from repro_torch.kernels import ops, ref

    errs = {"consensus_update_pop": 0.0, "quant_consensus_pop": 0.0}

    def compare(name, got, want, tol, what):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        errs[name] = max(errs[name], err)
        if not torch.isfinite(got.float()).all() or err > tol:
            fail(f"{name} {what}: max |kernel - plain| = {err} > {tol}")

    cases = [("ring", K_POP, topology.ring(K_POP)),
             ("small_world", K_POP, topology.small_world(K_POP, k=4, seed=1)),
             ("cluster", 2, topology.clusters(1, 2))]
    pops = {}
    for gname, K, topo in cases:
        if K not in pops:
            pops[K] = stacked_params(cfg, K, generator)
        idx, sig = (torch.as_tensor(a, device=DEVICE)
                    for a in consensus.sparse_structure(topo.mixing()))
        for leaf, x in pops[K].items():
            xf = x.reshape(K, -1)
            what = f"{gname} K={K} H={idx.shape[1]} {leaf} N={xf.shape[1]}"
            bf16 = codecs.get_codec("bf16")
            for spec in (None, "bf16"):
                xin = xf if spec is None else bf16.decode_leaf(
                    bf16.encode_leaf(xf), xf.shape[1])
                compare("consensus_update_pop",
                        ops.consensus_update_pop(xin, idx, sig),
                        ref.consensus_update_pop_reference(xin, idx, sig),
                        F32_TOL, f"{what} codec={spec}")
            xb = xf.to(torch.bfloat16)
            compare("consensus_update_pop",
                    ops.consensus_update_pop(xb, idx, sig),
                    ref.consensus_update_pop_reference(xb, idx, sig),
                    BF16_TOL, f"{what} bf16 tensors")
            for spec in ("int8", "int4", "int8:b64"):
                c = codecs.get_codec(spec)
                enc = c.encode_leaf(xf)
                compare("quant_consensus_pop",
                        ops.quant_consensus_pop(xf, enc["q"], enc["scale"],
                                                idx, sig, qblock=c.block),
                        ref.quant_consensus_pop_reference(
                            xf, enc["q"], enc["scale"], idx, sig, c.block),
                        F32_TOL, f"{what} codec={spec}")
        print(f"{gname:11s} K={K:3d} H={idx.shape[1]}: {len(pops[K])} leaves "
              f"x (None, bf16, bf16 tensors, int8, int4, int8:b64) agree; "
              f"max err so far {errs} (tolerance f32 {F32_TOL}, "
              f"bf16 tensors {BF16_TOL})", flush=True)
    return pops, errs


def time_kernels(pops, errs):
    from repro_torch.comms import codecs
    from repro_torch.core import consensus, topology
    from repro_torch.kernels import ops, ref, work

    rows = {}
    for K, topo in ((K_POP, topology.ring(K_POP)), (2, topology.clusters(1, 2))):
        mix = topo.mixing()
        idx, sig = (torch.as_tensor(a, device=DEVICE)
                    for a in consensus.sparse_structure(mix))
        H = idx.shape[1]
        xf = pops[K]["fc1.w"].reshape(K, -1)
        N = xf.shape[1]
        M = torch.as_tensor(consensus._effective_mix(mix), device=DEVICE)
        # bytes: x read and out written (4 + 4 per element), lane tables;
        # flops: sub, mul, add per neighbour per element, then x + acc
        b2 = bound(*same_work("consensus_update_pop",
                              work.consensus_update_pop(K, N, H),
                              (8 * K * N + 8 * K * H, 3 * K * N * H + K * N)))
        t_b2 = (median_ms(lambda: ops.consensus_update_pop(xf, idx, sig)),
                median_ms(lambda: ref.consensus_update_pop_reference(
                    xf, idx, sig)),
                median_ms(lambda: M @ xf))
        c = codecs.get_codec("int8")
        enc = c.encode_leaf(xf)
        q, s = enc["q"], enc["scale"]
        # bytes: x, out (4 + 4), int8 lanes (1) per element, scales, lanes;
        # flops: dequant, sub, mul, add per neighbour, own dequant, x + acc
        b1 = bound(*same_work(
            "quant_consensus_pop", work.quant_consensus_pop(K, N, H, s.numel()),
            (9 * K * N + 4 * K + 8 * K * H, 4 * K * N * H + 2 * K * N)))
        t_b1 = (median_ms(lambda: ops.quant_consensus_pop(xf, q, s, idx, sig)),
                median_ms(lambda: ref.quant_consensus_pop_reference(
                    xf, q, s, idx, sig)))
        print(f"fc1.w K={K} H={H} N={N}: consensus_update_pop kernel_ms="
              f"{t_b2[0]} plain_ms={t_b2[1]} library_ms(matmul)={t_b2[2]} "
              f"bound_ms={b2[0]} ({b2[1]})", flush=True)
        print(f"fc1.w K={K} H={H} N={N}: quant_consensus_pop(int8) kernel_ms="
              f"{t_b1[0]} plain_ms={t_b1[1]} library_ms=None "
              f"bound_ms={b1[0]} ({b1[1]})", flush=True)
        if K == K_POP:
            rows["consensus_update_pop"] = dict(
                route="cuda",
                source="src/repro_torch/kernels/csrc/consensus_update.cu",
                replaces="src/repro/kernels/consensus_update.py:34",
                ms=t_b2[0], plain_ms=t_b2[1], bound_ms=b2[0], bound_by=b2[1],
                library_ms=t_b2[2])
            rows["quant_consensus_pop"] = dict(
                route="cuda",
                source="src/repro_torch/kernels/csrc/quant_consensus.cu",
                replaces="src/repro/kernels/quant_consensus.py:76",
                ms=t_b1[0], plain_ms=t_b1[1], bound_ms=b1[0], bound_by=b1[1],
                library_ms=None)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    print("kernels: " + ", ".join(f"{n} ({r['route']}, {r['source']})"
                                  for n, r in rows.items()), flush=True)
    return rows


def check_engine(pops):
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine

    x = pops[K_POP]
    for spec in (None, "int8", "int8:b64", "bf16"):
        eng = ConsensusEngine(topology.ring(K_POP), codec=spec, plan="auto")
        if eng.plan.kind != "sparse":
            fail(f"ring(256) codec={spec} resolved to {eng.plan.kind!r}")
        dense = ConsensusEngine(topology.ring(K_POP), codec=spec, plan="dense")
        got, st = eng.step(x, eng.init_state(x))
        want, wst = dense.step(x, dense.init_state(x))
        worst = 0.0
        for k in x:
            # round to nearest and zero EF state put the same lanes on the
            # wire in both plans, so they differ only in summation order:
            # 1e-5 plus a few f32 ulps of the largest value
            atol = 1e-5 + 4 * torch.finfo(torch.float32).eps * float(
                x[k].abs().max())
            err = float((got[k] - want[k]).abs().max())
            if not torch.isfinite(got[k]).all() or err > atol:
                fail(f"engine {spec} {k}: sparse vs dense {err} > {atol}")
            if st is not None and float((st[k] - wst[k]).abs().max()) > atol:
                fail(f"engine {spec} {k}: EF residuals disagree")
            worst = max(worst, err / atol)
        print(f"ring(256) codec={spec}: plan={eng.plan.kind}; sparse vs dense "
              f"max err {worst:.3g} of tolerance", flush=True)


def run_casestudy():
    """Each codec's run is one main path: the launch counters are set to 0
    just before it and read just after. The int8 wire must launch only the
    fused int-wire kernel, no codec only the f32 kernel, each once per leaf
    per FL round computed (whole chunks, frozen tail included)."""
    from repro_torch.core import energy
    from repro_torch.rl.casestudy import CaseStudy

    t0, max_rounds = 4, 8
    own = {"int8": "quant_consensus_pop", None: "consensus_update_pop"}
    by_path, walls = {}, {}
    for spec in ("int8", None):
        cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                       codec=spec, device=DEVICE)
        if cs.engine.plan.kind != "sparse":
            fail(f"case study engine resolved to {cs.engine.plan.kind!r}")
        leaves = len(cs.init_params(torch.Generator(device=DEVICE)))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        zero_counts()
        t = time.perf_counter()
        res = cs.run(gen, t0, max_rounds=max_rounds)
        torch.cuda.synchronize()
        wall = walls[spec] = time.perf_counter() - t
        got = launch_counts()
        s = res.summary()
        if len(res.meta_history) != t0 or not all(
                v == v and abs(v) < float("inf") for v in res.meta_history):
            fail(f"meta losses not finite: {res.meta_history}")
        if len(res.rounds_per_task) != 6 or not all(
                1 <= r <= max_rounds for r in res.rounds_per_task):
            fail(f"t_i out of range: {res.rounds_per_task}")
        want = energy.total_energy(cs.energy_params, t0, 3,
                                   res.rounds_per_task, cs.cluster_topology,
                                   cs.codec)
        if abs(res.E_total - want) > 1e-9 * want:
            fail(f"E_total {res.E_total} != Eq. (12) {want}")
        computed = sum(min(-(-r // cs.chunk) * cs.chunk, max_rounds)
                       for r in res.rounds_per_task)
        want_launches = {n: computed * leaves if n == own[spec] else 0
                         for n in got}
        print(f"codec={spec}: t_i={res.rounds_per_task} "
              f"E_total_kJ={s['E_total_kJ']} meta_loss={res.meta_history} "
              f"wall_s={wall} launches={got} (expected {want_launches}: "
              f"{computed} FL rounds x {leaves} leaves)", flush=True)
        if got != want_launches:
            fail(f"case study codec={spec} launched {got}, expected "
                 f"{want_launches}")
        by_path[str(spec).lower()] = got
    return by_path, walls


# -- dynamic: fading links and sleeping agents -----------------------------------

DYN_PROCESSES = ("dropout", "async", "both")


def dynamic_kw(name):
    """Engine arguments of one dynamic process: links fading with p = 0.3,
    agents awake with p = 0.7 (τ = 2, λ = 0.9), or both."""
    from repro_torch.core import topology
    graph = dict(graph=topology.GraphProcess.dropout(0.3, seed=1))
    agents = dict(agents=topology.AgentProcess.bernoulli(0.7), tau=2,
                  staleness_decay=0.9)
    return {"dropout": graph, "async": agents,
            "both": dict(graph, **agents)}[name]


def engine_gate(x):
    """The engine phase's gate: same lanes on the wire, only the summation
    order differs: 1e-5 plus 4 f32 ulps of the leaf's largest value."""
    return 1e-5 + 4 * torch.finfo(torch.float32).eps * float(x.abs().max())


def check_dynamic_engine(pops):
    """K = 256 paper-DQN stacks on ring and small_world(k=4), codecs None,
    int8, int8:b64 and bf16, three dynamic processes. The sparse plan's
    4 rounds of ``scan_rounds`` equal the same rounds driven one call at a
    time, bit for bit; in each of those rounds the dense plan, started
    from the same state, agrees within the gate (params and EF residuals)
    and draws the same activity and ages. Then the always-on reduction
    and the dead round, bit for bit."""
    from repro_torch.core import topology
    from repro_torch.core.engine import AsyncState, ConsensusEngine

    x = pops[K_POP]
    worst = 0.0
    for gname, topo in (("ring", topology.ring(K_POP)),
                        ("small_world", topology.small_world(K_POP, k=4,
                                                             seed=1))):
        for spec in (None, "int8", "int8:b64", "bf16"):
            for proc in DYN_PROCESSES:
                kw = dynamic_kw(proc)
                sparse = ConsensusEngine(topo, codec=spec, plan="sparse", **kw)
                dense = ConsensusEngine(topo, codec=spec, plan="dense", **kw)
                got, got_st = sparse.scan_rounds(x, rounds=4)
                p, st = x, sparse.init_state(x)
                is_async = sparse.agents is not None
                if is_async:
                    ast = sparse.init_async_state(device=DEVICE)
                    dast = dense.init_async_state(device=DEVICE)
                for t in range(4):
                    if is_async:
                        sp, sst, ast, ar = sparse.async_step(p, st, t=t,
                                                             state=ast)
                        dp, dst, dast, dar = dense.async_step(p, st, t=t,
                                                              state=dast)
                        idx = torch.as_tensor(sparse.lane_structure()[0],
                                              device=DEVICE).long()
                        rows = torch.arange(K_POP, device=DEVICE)[:, None]
                        valid = torch.as_tensor(sparse.lane_structure()[1],
                                                device=DEVICE)
                        if not torch.equal(ar.act, dar.act) or not torch.equal(
                                ar.age[valid], dar.age[rows, idx][valid]):
                            fail(f"dynamic {gname} {spec} {proc} round {t}: "
                                 "plans drew different activity or ages")
                    else:
                        sp, sst = sparse.step(p, st, t=t)
                        dp, dst = dense.step(p, st, t=t)
                    for k in x:
                        gate = engine_gate(p[k])
                        err = float((sp[k] - dp[k]).abs().max())
                        if not torch.isfinite(sp[k]).all() or err > gate:
                            fail(f"dynamic {gname} {spec} {proc} round {t} "
                                 f"{k}: sparse vs dense {err} > {gate}")
                        if sst is not None and float(
                                (sst[k] - dst[k]).abs().max()) > gate:
                            fail(f"dynamic {gname} {spec} {proc} round {t} "
                                 f"{k}: EF residuals disagree")
                        worst = max(worst, err / gate)
                    p, st = sp, sst
                for k in x:
                    if not torch.equal(got[k], p[k]) or (
                            st is not None and not torch.equal(got_st[k], st[k])):
                        fail(f"dynamic {gname} {spec} {proc}: scan_rounds "
                             "differs from its rounds one by one")
        print(f"{gname}({K_POP}): codecs (None, int8, int8:b64, bf16) x "
              f"{DYN_PROCESSES}: 4 rounds of scan_rounds on the sparse plan "
              f"= its steps bit for bit; each round within the dense plan's "
              f"gate; max err so far {worst:.3g} of the gate", flush=True)

    ring = topology.ring(K_POP)
    for spec in (None, "int8"):
        for graph in (None, topology.GraphProcess.dropout(0.3, seed=1)):
            lock = ConsensusEngine(ring, codec=spec, plan="sparse", graph=graph)
            on = ConsensusEngine(ring, codec=spec, plan="sparse", graph=graph,
                                 agents=topology.AgentProcess.always_on())
            a, sa = lock.scan_rounds(x, rounds=2)
            b, sb = on.scan_rounds(x, rounds=2)
            if any(not torch.equal(a[k], b[k]) for k in x) or (
                    sa is not None and any(not torch.equal(sa[k], sb[k])
                                           for k in x)):
                fail(f"always-on codec={spec} graph={graph!r} differs from "
                     "lockstep")
        dead = ConsensusEngine(ring, codec=spec, plan="sparse",
                               agents=topology.AgentProcess.departure(
                                   [0] * K_POP))
        st = None if spec is None else {k: torch.full_like(v, 1e-3)
                                        for k, v in x.items()}
        p, st2, _, ar = dead.async_step(
            x, st, t=0, state=dead.init_async_state(device=DEVICE))
        if ar.act.any() or any(not torch.equal(p[k], x[k]) for k in x) or (
                st is not None and any(not torch.equal(st2[k], st[k])
                                       for k in x)):
            fail(f"dead round codec={spec} moved params or residuals")
    print(f"always-on (tau=None) = lockstep bit for bit on the sparse plan "
          f"(static and fading ring({K_POP}), codecs None and int8); a round "
          "in which every agent sleeps leaves params and residuals as they "
          "were", flush=True)


def check_dynamic_masks():
    """Survival and availability drawn on the card for a chunk of rounds
    equal the same draws on the CPU (dense grid, per-edge lanes through
    the engine, per-agent rates)."""
    import numpy as np
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine

    topo = topology.small_world(K_POP, k=4, seed=1)
    ts = torch.arange(3, 11)
    rates = np.random.default_rng(0).uniform(size=K_POP)
    pairs = []
    for dev in ("cpu", DEVICE):
        eng = ConsensusEngine(topo, plan="sparse", **dynamic_kw("both"))
        pairs.append((
            topology.survival_mask(topo.adjacency, 0.3,
                                   topology.survival_key(7, dev),
                                   ts.to(dev)).cpu(),
            eng.round_survival(ts.to(dev)).cpu(),
            eng.availability(ts.to(dev)).cpu(),
            topology.availability_mask(K_POP, rates,
                                       topology.availability_key(5, dev),
                                       ts.to(dev)).cpu()))
    names = ("survival (K, K)", "lanes (K, H)", "bernoulli availability",
             "per-agent availability")
    for name, a, b in zip(names, *pairs):
        if not torch.equal(a, b):
            fail(f"{name} masks drawn on the card differ from the CPU's")
    print(f"masks of rounds 3..10 drawn on the card equal the CPU's: "
          f"{', '.join(names)} (shares True: "
          f"{[float(a.float().mean()) for a in pairs[1]]})", flush=True)


def check_dynamic_kernels(pops, errs):
    """B1 and B2 at the timed leaf (fc1.w, N = 262,144, K = 256) on σ tables
    of async rounds with fading links: zeros on faded, sleeping and
    padding lanes, λ^age weights on stale lanes. Gate as in ``kernels``."""
    from repro_torch.comms import codecs
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.kernels import ops, ref

    xf = pops[K_POP]["fc1.w"].reshape(K_POP, -1)
    for gname, topo in (("ring", topology.ring(K_POP)),
                        ("small_world", topology.small_world(K_POP, k=4,
                                                             seed=1))):
        eng = ConsensusEngine(topo, plan="sparse", **dynamic_kw("both"))
        age = eng.init_async_state(device=DEVICE).age
        fractional = zeros = 0
        for t in range(4):
            ar = eng.async_round(t, age)
            age = ar.age
            idx, sig = eng._lane_sigma(ar.weights)
            w = ar.weights
            fractional += int(((w > 0) & (w < 1)).sum())
            zeros += int((sig == 0).sum())
            for dtype in (torch.float32, torch.bfloat16):
                xd = xf.to(dtype)
                got = ops.consensus_update_pop(xd, idx, sig)
                want = ref.consensus_update_pop_reference(xd, idx, sig)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                errs["consensus_update_pop"] = max(
                    errs["consensus_update_pop"], err)
                if err > (F32_TOL if dtype == torch.float32 else BF16_TOL):
                    fail(f"consensus_update_pop {gname} round {t} {dtype}: "
                         f"{err}")
            for spec in ("int8", "int8:b64"):
                c = codecs.get_codec(spec)
                enc = c.encode_leaf(xf)
                got = ops.quant_consensus_pop(xf, enc["q"], enc["scale"], idx,
                                              sig, qblock=c.block)
                want = ref.quant_consensus_pop_reference(
                    xf, enc["q"], enc["scale"], idx, sig, c.block)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                errs["quant_consensus_pop"] = max(
                    errs["quant_consensus_pop"], err)
                if err > F32_TOL:
                    fail(f"quant_consensus_pop {gname} round {t} {spec}: "
                         f"{err}")
        print(f"{gname}({K_POP}) fc1.w N={xf.shape[1]}: 4 async rounds with "
              f"fading links, {zeros} sigma = 0 lanes and {fractional} "
              f"lambda^age weights; B2 (f32, bf16) and B1 (int8, int8:b64) "
              f"equal their plain versions (max err {errs})", flush=True)


DYN_CS = dict(t0=4, max_rounds=8)


def dynamic_casestudy(spec, telemetry=None):
    """The case study on fading links (p = 0.3) and sleeping robots (awake
    with p = 0.75, τ = 2, λ = 0.9) on the sparse plan."""
    from repro_torch.core import topology
    from repro_torch.rl.casestudy import CaseStudy
    return CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                     codec=spec, dropout_p=0.3,
                     availability=topology.AgentProcess.bernoulli(0.75),
                     tau=2, staleness_decay=0.9, device=DEVICE,
                     telemetry=telemetry)


def run_dynamic_casestudy():
    """The dynamic case study, codecs int8 and None; each run counted
    from 0. Each must launch its own kernel once per leaf per FL round
    computed and the other never; the bill of the wires the card
    delivered equals the host replay (==) and is no more than the static
    bill; E_total is Eq. (12) with the measured joules. Returns the int8
    run too, for the ``drivers`` phase."""
    import numpy as np
    from repro_torch.core import energy
    from repro_torch.rl.casestudy import delivered_comm_joules

    t0, max_rounds = DYN_CS["t0"], DYN_CS["max_rounds"]
    own = {"int8": "quant_consensus_pop", None: "consensus_update_pop"}
    by_path, walls = {}, {}
    for spec in ("int8", None):
        cs = dynamic_casestudy(spec)
        leaves = len(cs.init_params(torch.Generator(device=DEVICE)))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        zero_counts()
        t = time.perf_counter()
        res = cs.run(gen, t0, max_rounds=max_rounds)
        torch.cuda.synchronize()
        walls[spec] = time.perf_counter() - t
        got = launch_counts()
        ep, base = cs.energy_params, cs.cluster_topology
        static = base.round_comm_joules(ep, codec=cs.codec)
        measured = res.fl_comm_joules_measured
        if measured is None or len(measured) != 6:
            fail(f"dynamic case study billed {measured}")
        for tid, t_i in enumerate(res.rounds_per_task):
            lanes = cs.fl_delivered[tid]
            idx, _ = cs._engines[tid].lane_structure()
            masks = np.zeros((t_i, base.K, base.K), bool)
            for r in range(t_i):
                masks[r, np.arange(base.K)[:, None], idx] = lanes[r]
            bill = delivered_comm_joules(base, masks, ep, cs.codec)
            if bill != measured[tid] or bill > t_i * static:
                fail(f"task {tid}: card-delivered bill {bill} vs host replay "
                     f"{measured[tid]}, static {t_i * static}")
        want = energy.maml_energy(ep, t0, cs.network.Q) + sum(
            energy.fl_learning_energy(ep, t_i, base) + c
            for t_i, c in zip(res.rounds_per_task, measured))
        if abs(res.E_total - want) > 1e-9 * want:
            fail(f"E_total {res.E_total} != Eq. (12) {want}")
        computed = sum(min(-(-r // cs.chunk) * cs.chunk, max_rounds)
                       for r in res.rounds_per_task)
        want_launches = {n: computed * leaves if n == own[spec] else 0
                         for n in got}
        print(f"dynamic codec={spec}: t_i={res.rounds_per_task} "
              f"E_total_kJ={res.summary()['E_total_kJ']} comm_J={measured} "
              f"(static bill {[t_i * static for t_i in res.rounds_per_task]}) "
              f"wall_s={walls[spec]} launches={got} (expected "
              f"{want_launches})", flush=True)
        if got != want_launches:
            fail(f"dynamic case study codec={spec} launched {got}, expected "
                 f"{want_launches}")
        by_path[f"dynamic_{str(spec).lower()}"] = got
        if spec == "int8":
            int8_run = (cs, res, got)
    return by_path, walls, int8_run


def profile_dynamic_round(rounds=3):
    """Dynamic FL rounds (2 robots, int8, sparse plan, fading links and
    sleeping robots) as the case study runs them: ``rounds`` rounds fed
    by one chunk's draws, made beforehand. Host wall per round and, from
    ``torch.profiler`` traces, kernels and device time per round; then a
    chunk's draws (8 rounds of survival and availability in one call),
    whose host time and kernels count 1/8 to each round, and one round's
    ``async_round`` + lane σ (inside the round's kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import topology
    from repro_torch.core.engine import AsyncState
    from repro_torch.rl.casestudy import CaseStudy

    cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                   codec="int8", dropout_p=0.3,
                   availability=topology.AgentProcess.bernoulli(0.75), tau=2,
                   staleness_decay=0.9, device=DEVICE)
    eng = cs.engine
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    C = cs.network.devices_per_cluster
    stacked = {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
               for k, v in cs.init_params(gen).items()}
    state = eng.init_state(stacked)
    astate = eng.init_async_state(device=DEVICE)
    acts_both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def draws():
        ts = torch.arange(0, cs.chunk, device=DEVICE)
        return eng.round_survival(ts), eng.availability(ts)

    links, acts = draws()

    def run():
        nonlocal stacked, state, astate
        for i in range(rounds):
            ar = eng.async_round(i, astate.age, act=acts[i], link=links[i])
            stacked, state, _ = cs.fl_round(0, stacked, state, gen,
                                            survival=ar.weights, active=ar.act)
            astate = AsyncState(astate.clock + ar.act.to(torch.int32), ar.age)
        torch.cuda.synchronize()

    run()                                            # warm-up
    t = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t) / rounds * 1e3
    with profile(activities=acts_both) as prof:
        run()
    out, kernels = trace_kernels(prof, "casestudy_dynamic_fl_round")
    busy_ms = sum(e.get("dur", 0) for e in kernels) / rounds / 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    draws()
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=acts_both) as prof:
        draws()
        torch.cuda.synchronize()
    _, k_chunk = trace_kernels(prof, "chunk_draws")
    with profile(activities=acts_both) as prof:
        ar = eng.async_round(0, astate.age, act=acts[0], link=links[0])
        eng._lane_sigma(ar.weights)
        torch.cuda.synchronize()
    _, k_round = trace_kernels(prof, "async_round")
    per_round = len(kernels) / rounds + len(k_chunk) / cs.chunk
    wall = wall_ms + draw_ms / cs.chunk
    print(f"dynamic FL round (2 robots, int8, sparse, p=0.3, awake 0.75) "
          f"at chunk {cs.chunk}: wall_ms={wall} kernels_per_round="
          f"{per_round} device_busy_ms={busy_ms} busy_share={busy_ms / wall} "
          f"(trace {out}); of which a chunk's draws: {len(k_chunk)} kernels "
          f"and host_ms={draw_ms} per {cs.chunk} rounds, async_round + lane "
          f"sigma: {len(k_round)} kernels a round", flush=True)
    if kernels:
        top_kernels(kernels, rounds)


# -- drivers: per-round telemetry and the chunked protocol drivers ---------------

DRV_ROUNDS = 8
#: repetitions of each telemetry mode in the walls of ``drivers`` (a)
DRV_REPS = 7
DRV_FL = dict(max_rounds=12, chunk=8, lr=0.3)


def driver_engine(spec):
    """The K = 256 population of the ``drivers`` phase: small_world(k=4),
    sparse plan, links fading (p = 0.3) and agents sleeping (awake with
    p = 0.7, τ = 2, λ = 0.9)."""
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine
    eng = ConsensusEngine(topology.small_world(K_POP, k=4, seed=1), codec=spec,
                          plan="sparse", **dynamic_kw("both"))
    if eng.plan.kind != "sparse":
        fail(f"drivers engine resolved to {eng.plan.kind!r}")
    return eng


def host_replay_masks(topo, rounds):
    """The wires delivered in rounds 0..rounds-1 of ``driver_engine``'s
    processes, replayed from the host streams: (K, K) bools per round."""
    from repro_torch.core import topology
    drops = topology.dropout(topo, 0.3, seed=1, rounds=rounds)
    acts = topology.availability_stream(topology.AgentProcess.bernoulli(0.7),
                                        topo.K, rounds)
    return [d.adjacency & a[:, None] & a[None, :] for d, a in zip(drops, acts)]


def count_kernels(fn, name):
    """Device kernels ``fn`` launches, from a ``torch.profiler`` trace
    (kept as ``build/profile/<name>.json``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(trace_kernels(prof, name)[1])


def check_scan_rounds_telemetry(x):
    """(a) 8 rounds of ``scan_rounds`` on the int8 wire: buffered
    telemetry leaves params and EF state bit for bit as telemetry off, and
    launches B1 exactly as often (10 × 8); every row's link counts and
    per-agent counts equal the host replay and the summed joules equal its
    bill (``==``). Then walls of off / buffered / streaming runs (each
    mode ``DRV_REPS`` times, alternating; median and spread) and the
    kernels a row adds per round."""
    import numpy as np
    from repro_torch.core import topology
    from repro_torch.rl.casestudy import delivered_comm_joules
    from repro_torch.telemetry import MemorySink, Telemetry

    eng = driver_engine("int8")
    leaves, R = len(x), DRV_ROUNDS
    want = {n: (leaves * R if n == "quant_consensus_pop" else 0)
            for n in KERNELS}
    runs = {}
    for mode in (None, "buffered"):
        tel = None if mode is None else Telemetry()
        zero_counts()
        out = eng.scan_rounds(x, rounds=R, telemetry=tel)
        torch.cuda.synchronize()
        runs[mode] = (out, launch_counts(), tel)
    (off, off_st), off_n, _ = runs[None]
    (on, on_st), on_n, tel = runs["buffered"]
    if any(not torch.equal(off[k], on[k]) or not torch.equal(off_st[k],
                                                             on_st[k])
           for k in x):
        fail("scan_rounds with telemetry differs from telemetry off")
    if off_n != want or on_n != want:
        fail(f"scan_rounds launched {off_n} (off) / {on_n} (buffered), "
             f"expected {want}")
    topo = eng.topology
    masks = host_replay_masks(topo, R)
    ev = tel.events(driver="consensus")
    if [e["round"] for e in ev] != list(range(R)):
        fail(f"scan_rounds telemetry rounds {[e['round'] for e in ev]}")
    lc = np.asarray(topo.link_class)
    for e, m in zip(ev, masks):
        for cls, code in (("sl", topology.SL), ("ul", topology.UL),
                          ("dl", topology.DL)):
            hit = m & (lc == code)
            if e[f"n_{cls}"] != int(hit.sum()) or \
                    e[f"agent_{cls}"] != hit.sum(0).tolist():
                fail(f"round {e['round']} {cls}: row counts differ from the "
                     "host replay")
    bill = delivered_comm_joules(topo, masks, tel.energy_params, eng.codec)
    if tel.joules(driver="consensus") != bill:
        fail(f"telemetry joules {tel.joules(driver='consensus')} != host "
             f"replay {bill}")
    # each mode DRV_REPS times, the order reversed every other repetition
    # so that a drift of the host's speed falls on every mode alike
    walls = {m: [] for m in ("off", "buffered", "streaming")}
    for rep in range(DRV_REPS):
        for mode in (tuple(walls) if rep % 2 == 0 else tuple(walls)[::-1]):
            t_ = (None if mode == "off" else
                  Telemetry(mode=mode, sinks=(MemorySink(),)))
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.scan_rounds(x, rounds=R, telemetry=t_)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t) * 1e3 / R)
    med = {m: statistics.median(w) for m, w in walls.items()}
    spread = {m: max(w) - min(w) for m, w in walls.items()}
    row_cost = [b - o for b, o in zip(walls["buffered"], walls["off"])]
    stream_cost = [s_ - b for s_, b in zip(walls["streaming"],
                                           walls["buffered"])]
    k_off = count_kernels(lambda: eng.scan_rounds(x, rounds=R),
                          "scan_rounds_off")
    k_on = count_kernels(lambda: eng.scan_rounds(x, rounds=R,
                                                 telemetry=Telemetry()),
                         "scan_rounds_buffered")
    print(f"(a) scan_rounds {R} rounds, K={K_POP} small_world int8 sparse, "
          f"fading + sleeping: telemetry off == buffered bit for bit; "
          f"launches {on_n} both; rows == host replay; joules "
          f"{tel.joules(driver='consensus')} == replay {bill}; edges per "
          f"round {[e['edges'] for e in ev]}, n_active "
          f"{[e['n_active'] for e in ev]}, disagreement "
          f"{[e['disagreement'] for e in ev]}", flush=True)
    print(f"(a) wall ms per round over {DRV_REPS} alternating runs of "
          f"each mode, median (max - min): "
          + ", ".join(f"{m} {med[m]} ({spread[m]})" for m in walls)
          + f"; per repetition, buffered - off: median "
          f"{statistics.median(row_cost)} (min {min(row_cost)}, max "
          f"{max(row_cost)}), streaming - buffered: median "
          f"{statistics.median(stream_cost)} (min {min(stream_cost)}, max "
          f"{max(stream_cost)}); runs {walls}", flush=True)
    print(f"(a) kernels per round off {k_off / R}, buffered {k_on / R} (a "
          f"row adds {(k_on - k_off) / R})", flush=True)
    from repro_torch.core import scanloop
    recs = eng.program_records()
    if not recs or any(r.why_uncaptured != scanloop.OVER_BYTE_CAP
                       or r.captures for r in recs):
        fail(f"(a) K = {K_POP} int8 scan_rounds at the default byte cap: "
             f"programs {recs}, expected eager under the byte rule with no "
             "capture")
    print(f"(a) at the default byte cap ({scanloop.PROGRAM_CACHE_BYTES} B) "
          f"the {len(recs)} scan_rounds programs run eagerly under the byte "
          f"rule, none captured (carry + static inputs "
          f"{[r.over_cap_bytes for r in recs]} B); the walls above are "
          f"eager ({SMI})", flush=True)
    del eng
    check_scan_rounds_captured(x, want)
    return on_n


@contextlib.contextmanager
def cap_lifted():
    """The program layer's byte cap lifted (``PROGRAM_CACHE_BYTES =
    None``) inside the block; restored and applied on exit."""
    from repro_torch.core import scanloop
    cap = scanloop.PROGRAM_CACHE_BYTES
    scanloop.PROGRAM_CACHE_BYTES = None
    try:
        yield
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap
        scanloop.trim_program_cache()


def check_scan_rounds_captured(x, want):
    """(a) With the byte cap lifted, the same 8 K = 256 rounds replaying
    the engine's captured round program, twice (capture, then a replay
    of the held program), ``==`` ``uncaptured()``: params, EF state, every
    telemetry row and the B1 launches (10 × 8 inside the graphs), off and
    buffered."""
    from repro_torch.core import scanloop
    from repro_torch.telemetry import Telemetry

    R = DRV_ROUNDS
    with cap_lifted():
        eng = driver_engine("int8")

        def run(mode):
            tel = None if mode is None else Telemetry()
            zero_counts()
            p, st = eng.scan_rounds(x, rounds=R, telemetry=tel)
            torch.cuda.synchronize()
            return (p, st, None if tel is None else tel.events(
                live_only=False)), launch_counts()

        for mode in (None, "buffered"):
            runs = [run(mode), run(mode)]
            with scanloop.uncaptured():
                eager = run(mode)
            if not all(same(r[0], eager[0]) for r in runs) or any(
                    r[1] != want or eager[1] != want for r in runs):
                fail(f"(a) scan_rounds captured (telemetry {mode}) differs "
                     f"from uncaptured(), or launches {[r[1] for r in runs]}"
                     f" / {eager[1]} != {want}")
        recs = eng.program_records()
        # the capture's call runs eagerly before it; the rest replay
        if len(recs) != 2 or not all(r.captured and r.captures == 1
                                     and r.replays == 2 * R - 1
                                     and r.in_place for r in recs):
            fail(f"(a) captured scan_rounds programs: {recs}")
        held = [r.held_bytes for r in recs]
        print(f"(a) byte cap lifted: scan_rounds K={K_POP} int8 replaying "
              f"its captured round program (off and buffered, 2 calls each)"
              f" == uncaptured() on params, EF state, rows and launches "
              f"{want}; held bytes {held}, capture s "
              f"{[r.capture_seconds for r in recs]} ({SMI})", flush=True)
        del eng, recs


def check_fl_drivers(x):
    """(b) ``run_fl_until_scan`` (chunk 8) against ``run_fl_until`` on the
    f32 wire (B2): each agent pulls each leaf toward a target made from
    the seed (loss ½‖w − w*‖²), the threshold from a probe run so the hit
    lands mid-chunk. Both with buffered telemetry: params, t_i, history
    and the live rows bit for bit; B2 launches 10 × rounds computed."""
    from repro_torch.core import federated
    from repro_torch.telemetry import Telemetry

    eng = driver_engine(None)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    target = {k: torch.randn(v.shape[1:], generator=g, device=DEVICE)
              for k, v in x.items()}
    batches = {k: v.expand((K_POP, 1) + v.shape) for k, v in target.items()}

    def loss(p, b):
        return sum(0.5 * (p[k] - b[k]).square().sum() for k in p)

    def sample(_generator, _t):
        return batches

    def dist(sp):
        return sum((sp[k] - target[k]).square().mean() for k in sp)

    def run(driver, thr, **kw):
        def target_fn(sp):
            m = dist(sp)
            return m < thr, m
        tel = Telemetry()
        zero_counts()
        t = time.perf_counter()
        p, t_i, hist = driver(loss, x, sample, eng, DRV_FL["lr"],
                              target_fn=target_fn,
                              max_rounds=DRV_FL["max_rounds"],
                              generator=torch.Generator(device=DEVICE),
                              telemetry=tel, **kw)
        torch.cuda.synchronize()
        return (p, t_i, hist, tel, launch_counts(),
                time.perf_counter() - t)

    probe = run(federated.run_fl_until_scan, -1.0, chunk=DRV_FL["chunk"])[2]
    thr = probe[2] * 0.999
    res = {"chunk 8": run(federated.run_fl_until_scan, thr,
                          chunk=DRV_FL["chunk"]),
           "chunk 1": run(federated.run_fl_until, thr)}
    p8, t8, h8, tel8, n8, w8 = res["chunk 8"]
    p1, t1, h1, tel1, n1, w1 = res["chunk 1"]
    if not 1 < t8 < DRV_FL["chunk"] or (t8, h8) != (t1, h1) or any(
            not torch.equal(p8[k], p1[k]) for k in p8):
        fail(f"run_fl_until_scan (t_i {t8}, history {h8}) differs from "
             f"run_fl_until (t_i {t1}, history {h1}) or missed mid-chunk")
    if tel8.events(driver="fl") != tel1.events(driver="fl") or \
            len(tel8.events(driver="fl")) != t8:
        fail("run_fl_until_scan live rows differ from run_fl_until's")
    leaves = len(x)
    computed = {"chunk 8": min(-(-t8 // DRV_FL["chunk"]) * DRV_FL["chunk"],
                               DRV_FL["max_rounds"]), "chunk 1": t1}
    for name, n in (("chunk 8", n8), ("chunk 1", n1)):
        want = {k: (leaves * computed[name] if k == "consensus_update_pop"
                    else 0) for k in KERNELS}
        if n != want:
            fail(f"run_fl_until {name} launched {n}, expected {want}")
    print(f"(b) FL drivers K={K_POP} f32 sparse, fading + sleeping: probe "
          f"history {probe}; threshold {thr}; t_i {t8} at chunk 8 == chunk 1, "
          f"params, history and {t8} live rows bit for bit; launches chunk 8 "
          f"{n8} ({computed['chunk 8']} rounds computed), chunk 1 {n1}; wall "
          f"s chunk 8 {w8}, chunk 1 {w1}; joules {tel8.joules()}", flush=True)
    return n8


def run_streaming_casestudy(off):
    """(c) The ``dynamic`` phase's int8 case study again, with streaming
    telemetry into ``build/telemetry.jsonl``: t_i, histories, E_total,
    adapted params and launches equal the telemetry-off run; per task the
    streamed joules equal the post-hoc bill and there are t_i ``fl``
    events; the log passes the port's schema."""
    from repro_torch.kernels import build
    from repro_torch.telemetry import JsonlSink, Telemetry, validate_jsonl

    cs0, res0, n0 = off
    path = build.BUILD_ROOT.parent / "telemetry.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    tel = Telemetry(mode="streaming", sinks=(JsonlSink(path),))
    cs = dynamic_casestudy("int8", telemetry=tel)
    zero_counts()
    t = time.perf_counter()
    res = cs.run(torch.Generator(device=DEVICE).manual_seed(0), DYN_CS["t0"],
                 max_rounds=DYN_CS["max_rounds"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = launch_counts()
    tel.close()
    same = (res.rounds_per_task == res0.rounds_per_task
            and res.meta_history == res0.meta_history
            and res.fl_histories == res0.fl_histories
            and res.E_total == res0.E_total
            and all(torch.equal(cs.fl_params[i][k], cs0.fl_params[i][k])
                    for i in cs0.fl_params for k in cs0.fl_params[i]))
    if not same:
        fail(f"streaming case study t_i {res.rounds_per_task} / E_total "
             f"{res.E_total} differs from telemetry off "
             f"{res0.rounds_per_task} / {res0.E_total} (or its histories "
             "or adapted params do)")
    if got != n0:
        fail(f"streaming case study launched {got}, telemetry off {n0}")
    per_task = [tel.joules(task_id=i) for i in range(6)]
    counts = [len([e for e in tel.events(driver="fl") if e["task_id"] == i])
              for i in range(6)]
    if per_task != res.fl_comm_joules_measured or \
            counts != res.rounds_per_task:
        fail(f"streamed joules {per_task} vs post-hoc "
             f"{res.fl_comm_joules_measured}; events {counts} vs t_i "
             f"{res.rounds_per_task}")
    n_events, errors = validate_jsonl(path)
    if errors or n_events != DYN_CS["t0"] + sum(res.rounds_per_task):
        fail(f"{path}: {n_events} valid events, problems {errors[:5]}")
    print(f"(c) streaming case study (int8, p=0.3, awake 0.75): t_i "
          f"{res.rounds_per_task}, E_total_kJ {res.summary()['E_total_kJ']}, "
          f"histories and adapted params == telemetry off; launches {got} "
          f"== off; streamed joules per task {per_task} == post-hoc bill; "
          f"{n_events} events in {path} pass the schema; wall_s {wall}",
          flush=True)
    return got


def run_protocol():
    """(d) ``MTLProtocol`` on the card: the paper-DQN Q-network regressed
    on the one-step rewards of each gridworld task (q(s, a) → r(s, a) /
    10), the case study's 2-robot clusters and meta tasks, t0 = 5,
    max_rounds 16, buffered telemetry. K = 2 sits below the sparse
    floor, so the engine is dense and no kernel launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import energy
    from repro_torch.core.multitask import ClusterNetwork
    from repro_torch.core.protocol import MTLProtocol
    from repro_torch.models import dqn as qmodel
    from repro_torch.rl import gridworld as gw
    from repro_torch.rl.casestudy import META_TASKS
    from repro_torch.telemetry import Telemetry

    cfg = get_arch("paper-dqn")
    cells = torch.arange(gw.NUM_CELLS, device=DEVICE)
    pos = torch.stack([cells // gw.GRID_H, cells % gw.GRID_H], -1)
    states = gw.one_hot_state(pos)
    rewards = torch.stack([torch.stack(
        [gw.step(pos, torch.full_like(cells, a), tid)[1]
         for a in range(gw.NUM_ACTIONS)], -1) for tid in range(gw.NUM_TASKS)]
    ).to(torch.float32) / 10.0                      # (tasks, 40, 4)

    def loss_fn(p, b):
        return (qmodel.forward(p, cfg, b["x"]) - b["y"]).square().mean()

    def batch(idx, task_id):
        return {"x": states[idx], "y": rewards[task_id][idx]}

    def sample_support(g, task_id, steps):
        return batch(torch.randint(0, gw.NUM_CELLS, (steps, 16), generator=g,
                                   device=DEVICE), task_id)

    def sample_query(g, task_id):
        return batch(torch.randint(0, gw.NUM_CELLS, (16,), generator=g,
                                   device=DEVICE), task_id)

    def target_fn(p, task_id):
        err = loss_fn(p, batch(cells, task_id))
        return err < 0.06, -err

    tel = Telemetry()
    proto = MTLProtocol(
        loss_fn=loss_fn,
        init_fn=lambda g: qmodel.init(cfg, generator=g, device=DEVICE),
        network=ClusterNetwork(num_tasks=gw.NUM_TASKS, devices_per_cluster=2,
                               meta_task_ids=META_TASKS),
        sample_support=sample_support, sample_query=sample_query,
        target_fn=target_fn, inner_lr=0.05, outer_lr=0.05, fl_lr=0.05,
        inner_steps=5, fl_local_steps=10, chunk=8, telemetry=tel)
    t0, max_rounds = 5, 16
    zero_counts()
    t = time.perf_counter()
    res = proto.run(torch.Generator(device=DEVICE).manual_seed(3), t0,
                    max_rounds=max_rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = launch_counts()
    want = energy.total_energy(proto.energy_params, t0, proto.net.Q,
                               res.rounds_per_task, proto.cluster_topology)
    per_round = proto.engine.round_comm_joules(proto.energy_params)
    joules = [tel.joules(task_id=i) for i in range(gw.NUM_TASKS)]
    if (proto.engine.plan.kind != "dense" or any(got.values())
            or len(res.meta_history) != t0
            or not all(abs(v) < float("inf") for v in res.meta_history)
            or not all(1 <= r <= max_rounds for r in res.rounds_per_task)
            or abs(res.E_total - want) > 1e-9 * want
            or joules != [sum([per_round] * r) for r in res.rounds_per_task]
            or len(tel.events(driver="maml")) != t0):
        fail(f"MTLProtocol: plan {proto.engine.plan.kind} launches {got} "
             f"t_i {res.rounds_per_task} meta {res.meta_history} E_total "
             f"{res.E_total} (Eq. (12) {want}) joules {joules}")
    print(f"(d) MTLProtocol paper-DQN regression on the card: plan "
          f"{proto.engine.plan.kind} (K = 2; no kernel launches: {got}); t0 "
          f"{t0}, meta losses {res.meta_history}, t_i {res.rounds_per_task}, "
          f"E_total_kJ {res.summary()['E_total_kJ']}, per-task telemetry "
          f"joules {joules}; wall_s {wall}", flush=True)
    return got



# -- programs: the compiled chunk program (CUDA graphs) -------------------------

#: the ``programs`` phase: case-study adaptations (one task, 8 FL rounds,
#: never reaching the target, after 2 meta rounds) at chunks 1 and 8; the
#: K = 256 ``run_fl_until_scan`` (12 rounds at most, chunk 8, against
#: ``run_fl_until``); timed rounds per run and runs per mode
PROG = dict(cs_t0=2, cs_rounds=8, chunks=(1, 8), fl_rounds=12, fl_chunk=8,
            timed_rounds=4, reps=3)
#: the dynamics of the == cases: static links and robots, links fading
#: with p = 0.3, robots awake with p = 0.75 (τ = 2, λ = 0.9)
PROG_DYN = ("static", "fading", "sleeping")


def same(a, b):
    """Bit equality of two pytrees of tensors (dicts, tuples, None)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def prog_case_study(spec, dyn, **kw):
    """A case study on its own K = 2 clusters (``auto``: the dense plan)
    with buffered telemetry, under one of ``PROG_DYN``."""
    from repro_torch.core import topology
    from repro_torch.rl.casestudy import CaseStudy
    from repro_torch.telemetry import Telemetry
    extra = {"static": {}, "fading": dict(dropout_p=0.3, dropout_seed=3),
             "sleeping": dict(availability=topology.AgentProcess.bernoulli(
                 0.75, seed=2), tau=2, staleness_decay=0.9)}[dyn]
    return CaseStudy(codec=spec, device=DEVICE, telemetry=Telemetry(),
                     **dict(extra, **kw))


def case_study_pass(cs, chunk):
    """Meta-train ``PROG['cs_t0']`` rounds, then adapt task 0 for
    ``PROG['cs_rounds']`` rounds at ``chunk``: every result a captured run
    and an ``uncaptured()`` run must share."""
    cs.chunk = chunk
    cs.telemetry.reset()
    g = torch.Generator(device=DEVICE).manual_seed(11)
    meta, meta_hist = cs.meta_train(g, PROG["cs_t0"])
    g2 = torch.Generator(device=DEVICE).manual_seed(12)
    params, t_i, hist = cs.adapt_task(g2, 0, meta,
                                      max_rounds=PROG["cs_rounds"])
    torch.cuda.synchronize()
    return {"meta": meta, "meta_history": meta_hist, "params": params,
            "t_i": t_i, "history": hist,
            "codec_state": cs.fl_codec_state[0],
            "async_state": cs.fl_async_state[0],
            "delivered": cs.fl_delivered.get(0),
            "generators": (g.get_state(), g2.get_state()),
            "rows": cs.telemetry.events(live_only=False)}


def check_case_study_programs():
    """(a) The case study's programs (the meta round and task 0's FL round,
    held per instance) captured against the same runs under
    ``scanloop.uncaptured()``: meta params and history, FL params, codec
    state, ``AsyncState``, t_i, history, both generators' final states,
    the telemetry rows and the delivered masks ``==``, on the int8 and
    f32 wires, static / fading / sleeping, at chunks 1 and 8."""
    from repro_torch.core import scanloop
    cases = 0
    for spec in ("int8", None):
        for dyn in PROG_DYN:
            cs = prog_case_study(spec, dyn, r_target=1e9)
            if cs.engine.plan.kind != "dense":
                fail(f"case study resolved to {cs.engine.plan.kind!r}")
            for chunk in PROG["chunks"]:
                got = case_study_pass(cs, chunk)
                with scanloop.uncaptured():
                    want = case_study_pass(cs, chunk)
                bad = [k for k in got if not same(got[k], want[k])]
                if bad:
                    fail(f"captured case study (codec={spec}, {dyn}, chunk "
                         f"{chunk}) differs from uncaptured() in {bad}")
                cases += 1
            recs = [cs._meta_program.record, cs._fl_programs[0].record]
            if not all(r.captured and r.replays for r in recs):
                fail(f"case study programs not captured: {recs}")
    print(f"(a) case study, dense plan (K = 2), {cases} cases (int8 / f32 x "
          f"{', '.join(PROG_DYN)} x chunks {PROG['chunks']}): captured == "
          "uncaptured() on meta params and history, FL params, codec "
          "state, AsyncState, t_i, history, generators, telemetry rows and "
          "delivered masks", flush=True)


def prog_fl_setup(x):
    """The K = 256 regression of the ``programs`` phase on ``x``: each
    round draws every agent's target from the generator (a sampler that
    passes the capture probe), so the program is cached and captured.
    Returns the loss, the sampler, and the device target and the host
    target (``float(m) < thr``, which fails the probe) for a threshold."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    target = {k: torch.randn(v.shape[1:], generator=g, device=DEVICE)
              for k, v in x.items()}

    def loss(p, b):
        return sum(0.5 * (p[k] - b[k]).square().sum() for k in p)

    def sample(generator, _t):
        return {k: target[k] + 0.1 * torch.randn(
            (K_POP, 1) + v.shape, generator=generator, device=DEVICE)
            for k, v in target.items()}

    def dist(sp):
        return sum((sp[k] - target[k]).square().mean() for k in sp)

    targets = {}

    def target_for(thr, host=False):
        # one function per threshold: the program cache keys on identity
        if (thr, host) not in targets:
            def target_fn(sp):
                m = dist(sp)
                return m < thr, m

            def host_target_fn(sp):
                m = dist(sp)
                return float(m) < thr, m
            targets[thr, host] = host_target_fn if host else target_fn
        return targets[thr, host]

    return loss, sample, target_for


def prog_engine(spec, dyn):
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine
    kw = {"static": {}, "fading": dynamic_kw("dropout"),
          "sleeping": dynamic_kw("async")}[dyn]
    eng = ConsensusEngine(topology.small_world(K_POP, k=4, seed=1),
                          codec=spec, plan="sparse", **kw)
    if eng.plan.kind != "sparse":
        fail(f"programs engine resolved to {eng.plan.kind!r}")
    return eng


def fl_pass(x, fns, eng, thr, chunk, max_rounds, every=1, host=False):
    """One ``run_fl_until_scan`` (``run_fl_until`` at chunk 1) with buffered
    telemetry and a generator; its launches counted from 0."""
    from repro_torch.core import federated
    from repro_torch.telemetry import Telemetry
    loss, sample, target_for = fns
    target_fn = target_for(thr, host)
    tel = Telemetry()
    g = torch.Generator(device=DEVICE).manual_seed(21)
    zero_counts()
    kw = dict(target_fn=target_fn, max_rounds=max_rounds, generator=g,
              telemetry=tel, eval_every=every, return_state=True)
    if chunk == 1:
        out = federated.run_fl_until(loss, x, sample, eng, DRV_FL["lr"],
                                     **kw)
    else:
        out = federated.run_fl_until_scan(loss, x, sample, eng,
                                          DRV_FL["lr"], chunk=chunk, **kw)
    torch.cuda.synchronize()
    p, t_i, hist, st = out
    return {"params": p, "t_i": t_i, "history": hist, "codec_state": st,
            "generator": g.get_state(),
            "rows": tel.events(live_only=False)}, launch_counts()


def fl_case(x, fns, spec, dyn, thr, chunk, every=1, host=False):
    """One K = 256 case captured and under ``uncaptured()``: fails unless
    every result is ``==`` and both launch B1 (int8) or B2 (f32) exactly
    once per leaf per round computed. Returns (t_i, rounds computed,
    the captured run's launches)."""
    from repro_torch.core import scanloop
    eng = prog_engine(spec, dyn)
    own = "quant_consensus_pop" if spec else "consensus_update_pop"
    got, n = fl_pass(x, fns, eng, thr, chunk, PROG["fl_rounds"], every, host)
    with scanloop.uncaptured():
        want, n_eager = fl_pass(x, fns, eng, thr, chunk, PROG["fl_rounds"],
                                every, host)
    bad = [k for k in got if not same(got[k], want[k])]
    computed = min(-(-got["t_i"] // chunk) * chunk, PROG["fl_rounds"])
    exp = {k: len(x) * computed if k == own else 0 for k in KERNELS}
    if bad or n != exp or n_eager != exp:
        fail(f"run_fl_until_scan codec={spec} {dyn} chunk {chunk} "
             f"eval_every {every} host target {host}: captured differs "
             f"from uncaptured() in {bad}, or launches {n} / {n_eager} != "
             f"{exp}")
    return got["t_i"], computed, n


def check_fl_programs(x, fns, thr):
    """(b) ``run_fl_until_scan`` at full width (paper-DQN x K = 256,
    small_world(k=4), the sparse plan) on the f32 (B2) and int8 (B1)
    wires, static / fading / sleeping, at chunk 8 and as ``run_fl_until``:
    the cached, captured program ``==`` the same run under
    ``uncaptured()`` (params, codec state, t_i, history, the generator's
    final state, telemetry rows), with the hit mid-chunk on the static f32
    case, and B1/B2 launching inside the graphs at 10 a round computed,
    counted through the replays. Returns the launches of the captured
    runs."""
    from repro_torch.core import scanloop
    total = {n: 0 for n in KERNELS}
    cases = []
    for spec in (None, "int8"):
        for dyn in PROG_DYN:
            for chunk in (PROG["fl_chunk"], 1):
                # a K = 256 program is above the default byte cap (eager
                # under the byte rule): lifted, so the graphs are held to
                # uncaptured(), and each case's program dropped after it,
                # before the cap returns
                with cap_lifted():
                    t_i, computed, n = fl_case(x, fns, spec, dyn, thr, chunk)
                    scanloop.clear_program_cache()
                for k in KERNELS:
                    total[k] += n[k]
                cases.append((spec, dyn, chunk, t_i, computed))
    print(f"(b) run_fl_until_scan K={K_POP} sparse, {len(cases)} cases "
          f"(codec, dynamics, chunk, t_i, rounds computed) {cases}: "
          "captured == uncaptured() on params, codec state, t_i, history, "
          "generator and rows; B1/B2 10 a round computed inside the "
          f"graphs (captured launches {total})", flush=True)
    return total


def check_fl_variants(x, fns, thr):
    """(e) The variants a run captures in its middle, at K = 256:
    ``eval_every=2`` (the skip round's graph, then the evaluating one,
    on the live carry), a target that reads the host (``float(m) <
    thr``: ``update`` and ``commit`` graphs around the host call, the
    program built per call and never cached), and both at once —
    captured ``==`` ``uncaptured()`` on params, codec state, t_i, history,
    generator and rows, B1/B2 10 a round computed. The byte cap is
    lifted, as in (b)."""
    from repro_torch.core import scanloop
    cases = []
    for spec, dyn, chunk, every, host in (
            ("int8", "fading", PROG["fl_chunk"], 2, False),
            (None, "static", PROG["fl_chunk"], 1, True),
            ("int8", "sleeping", 1, 2, True)):
        with program_records() as recs, cap_lifted():
            t_i, computed, _ = fl_case(x, fns, spec, dyn, thr, chunk, every,
                                       host)
            scanloop.clear_program_cache()
        ran = [r for r in recs if r.captures]
        want = 2 + host if every == 2 else 2
        if len(ran) != 1 or ran[0].captures != want or (
                host != (ran[0].host_fns == ("target_fn",))) or (
                host != (ran[0].cache_key is None)):
            fail(f"(e) codec={spec} {dyn} eval_every {every} host target "
                 f"{host}: programs {ran}")
        cases.append((spec, dyn, chunk, every, host, t_i, computed,
                      ran[0].captures))
    print(f"(e) K={K_POP} variants captured mid-run, {len(cases)} cases "
          "(codec, dynamics, chunk, eval_every, host target, t_i, rounds "
          f"computed, graphs captured) {cases}: captured == uncaptured() "
          "on params, codec state, t_i, history, generator and rows; "
          "B1/B2 10 a round computed; the host-target programs not cached",
          flush=True)


#: the B1 / B2 kernels' names in a profiler trace (the CUDA functions of
#: quant_consensus.cu and consensus_update.cu)
TRACE_NAMES = {"quant_consensus_pop": "quant_consensus_pop_kernel",
               "consensus_update_pop": "consensus_pop_kernel"}


def trace_launches(kernels):
    """B1 / B2 launches in a trace's kernel events, by wrapper."""
    out = {}
    for n, fn in TRACE_NAMES.items():
        out[n] = sum(1 for e in kernels if fn in e["name"] and not (
            n == "consensus_update_pop" and "quant_" in e["name"]))
    return out


def per_round(run, rounds, label):
    """(median wall ms a round over ``PROG['reps']`` runs, device ms a
    round, kernels a round, peak MB, B1/B2 launches in the trace and on
    the counters) of ``run()``, which computes ``rounds`` rounds; the
    kernels, device time and launches from one ``torch.profiler`` trace
    of one more run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(PROG["reps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / rounds)
    peak = torch.cuda.max_memory_allocated() / 1e6
    zero_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counted = {n: launch_counts()[n] for n in TRACE_NAMES}
    _, kernels = trace_kernels(prof, f"programs_{label}")
    busy = sum(e.get("dur", 0) for e in kernels) / rounds / 1e3
    return {"wall_ms_per_round": statistics.median(walls),
            "wall_ms_runs": walls, "kernels_per_round": len(kernels) / rounds,
            "device_ms_per_round": busy,
            "busy_share": busy / statistics.median(walls),
            "peak_allocated_mb": peak,
            "reserved_mb": torch.cuda.memory_reserved() / 1e6,
            "trace_launches": trace_launches(kernels),
            "counted_launches": counted}


def side_by_side(label, run, rounds, records):
    """Captured and eager (``uncaptured()``) ``run`` side by side, with the
    programs' captures, replays, capture seconds, launches a replay and
    held bytes. Fails unless the B1/B2 kernels the captured trace shows,
    by name, equal the launches the replays added to the counters and
    the eager trace's."""
    from repro_torch.core import scanloop
    run()                                 # captures, outside the timing
    cap = per_round(run, rounds, f"{label}_captured")
    with scanloop.uncaptured():
        run()
        eager = per_round(run, rounds, f"{label}_eager")
    recs = records()
    out = {"captured": cap, "eager": eager,
           "captures": sum(r.captures for r in recs),
           "replays": sum(r.replays for r in recs),
           "capture_s": sum(r.capture_seconds for r in recs),
           "launches_per_replay": [r.launches_per_replay for r in recs],
           "held_bytes": [r.held_bytes for r in recs]}
    if not (cap["trace_launches"] == cap["counted_launches"]
            == eager["trace_launches"] == eager["counted_launches"]):
        fail(f"{label}: B1/B2 in the captured trace "
             f"{cap['trace_launches']}, on the counters "
             f"{cap['counted_launches']}, in the eager trace "
             f"{eager['trace_launches']} (counters "
             f"{eager['counted_launches']}) differ")
    print(f"{label}: captured {cap['wall_ms_per_round']:.3f} ms a round "
          f"({cap['kernels_per_round']} kernels, busy "
          f"{cap['busy_share']:.3f}, peak {cap['peak_allocated_mb']:.0f} MB)"
          f"; eager {eager['wall_ms_per_round']:.3f} ms "
          f"({eager['kernels_per_round']} kernels, busy "
          f"{eager['busy_share']:.3f}, peak {eager['peak_allocated_mb']:.0f}"
          f" MB); B1/B2 in the captured trace {cap['trace_launches']} == "
          f"counters {cap['counted_launches']} == eager trace "
          f"{eager['trace_launches']} ({SMI}); {json.dumps(out)}",
          flush=True)
    return out


def time_programs(x, fns):
    """(c) Captured against eager: the case-study FL round of the
    ``profile`` phase (2 robots, int8, sparse), the meta round of
    ``paper`` (c), the K = 256 ``run_fl_until_scan`` (int8 and f32,
    static) and ``scan_rounds`` (int8, sparse, static) with the cache's
    byte cap lifted, so their programs are kept across calls, and the
    async fleet's ``scan_rounds`` (K = 8, int8, sparse, agents awake with
    p = 0.6, τ = 3, λ = 0.9, buffered telemetry); then the int8 driver at
    the default cap, whose program is above the cap: it must stay cached
    under the byte rule, never captured, every timed call a hit."""
    from repro_torch.core import scanloop, topology
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.launch import async_fleet
    from repro_torch.rl.casestudy import CaseStudy
    from repro_torch.telemetry import Telemetry
    R = PROG["timed_rounds"]
    out = {}
    cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                   codec="int8", device=DEVICE, r_target=1e9, chunk=R)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    init = cs.init_params(gen)
    out["casestudy_fl_round"] = side_by_side(
        "case-study FL round (2 robots, int8, sparse)",
        lambda: cs.adapt_task(gen, 0, init, max_rounds=R), R,
        lambda: [cs._fl_programs[0].record])
    pc = paper_casestudy()
    pinit = pc.init_params(gen)
    out["meta_round"] = side_by_side(
        "meta round (3 tasks x 10 inner steps, paper-DQN)",
        lambda: pc.run_meta(gen, pinit, R), R,
        lambda: [pc._meta_program.record])
    del cs, init, pc, pinit
    with cap_lifted():
        for spec in ("int8", None):
            eng = prog_engine(spec, "static")
            out[f"fl_k256_{spec or 'f32'}"] = side_by_side(
                f"run_fl_until_scan K={K_POP} ({spec or 'f32'}, sparse, "
                "static; byte cap lifted)",
                lambda: fl_pass(x, fns, eng, -1.0, R, R), R,
                lambda: [p.record for k, p in
                         scanloop._program_cache.items() if k[4] is eng])
        scanloop.clear_program_cache()
        eng = prog_engine("int8", "static")
        out["scan_rounds_k256_int8"] = side_by_side(
            f"scan_rounds K={K_POP} (int8, sparse, static; byte cap lifted)",
            lambda: eng.scan_rounds(x, rounds=R), R, eng.program_records)
        del eng
    fleet = ConsensusEngine(
        topology.ring(async_fleet.K), codec="int8", plan="sparse",
        agents=topology.AgentProcess.bernoulli(0.6, seed=1), tau=3,
        staleness_decay=0.9)
    fx = async_fleet.fleet_params(DEVICE)
    out["scan_rounds_fleet_k8"] = side_by_side(
        f"scan_rounds async fleet K={async_fleet.K} (int8, sparse, p_active "
        "0.6, buffered telemetry)",
        lambda: fleet.scan_rounds(fx, rounds=async_fleet.ROUNDS,
                                  telemetry=Telemetry()),
        async_fleet.ROUNDS, fleet.program_records)
    del fleet, fx
    cap = scanloop.PROGRAM_CACHE_BYTES
    eng = prog_engine("int8", "static")
    with program_records() as recs:
        fl_pass(x, fns, eng, -1.0, R, R)
        hits0 = scanloop.cache_stats()["hits"]
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(PROG["reps"]):
            t = time.perf_counter()
            fl_pass(x, fns, eng, -1.0, R, R)
            walls.append((time.perf_counter() - t) * 1e3 / R)
        hits = scanloop.cache_stats()["hits"] - hits0
    kept = [p.record for k, p in scanloop._program_cache.items()
            if k[4] is eng]
    captures = sum(r.captures for r in recs)
    if (len(recs) != 1 or len(kept) != 1 or kept[0] is not recs[0]
            or captures or hits != PROG["reps"]
            or kept[0].why_uncaptured != scanloop.OVER_BYTE_CAP):
        fail(f"K = {K_POP} at the default byte cap {cap}: {len(recs)} "
             f"programs built, {len(kept)} kept, {captures} captures, "
             f"{hits} hits over {PROG['reps']} timed calls; expected one "
             "program, kept under the byte rule, never captured, every "
             "timed call a hit")
    eager_ms = out["fl_k256_int8"]["eager"]["wall_ms_per_round"]
    med = statistics.median(walls)
    out["fl_k256_int8_default_cap"] = {
        "wall_ms_per_round": med, "wall_ms_runs": walls,
        "eager_ms_per_round": eager_ms, "ratio_to_eager": med / eager_ms,
        "peak_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
        "captures": captures, "hits": hits,
        "why_uncaptured": kept[0].why_uncaptured,
        "over_cap_bytes": kept[0].over_cap_bytes,
        "held_bytes": kept[0].held_bytes}
    print(f"run_fl_until_scan K={K_POP} (int8) at the default byte cap "
          f"({cap} B): {med:.3f} ms a round over calls of {R} rounds, "
          f"{med / eager_ms:.4f} x the eager row's {eager_ms:.3f}; its "
          f"program kept under the byte rule ({kept[0].over_cap_bytes} B "
          f"above the cap before capture), {captures} captures, {hits} hits "
          f"in {PROG['reps']} timed calls ({SMI}); "
          f"{json.dumps(out['fl_k256_int8_default_cap'])}", flush=True)
    return out


def check_capture_failure():
    """(d) A capture that meets an op the graph refuses raises, naming the
    program and the op; nothing falls back to eager."""
    from repro_torch.core import scanloop
    prog = scanloop.donating_graph(
        lambda v: ((v * v.sum().item(),), v.sum()), donate_argnums=(0,),
        name="refused_capture")
    try:
        prog(torch.ones(4, device=DEVICE))
    except RuntimeError as e:
        msg = str(e)
        if "refused_capture" not in msg or "local_scalar_dense" not in msg:
            fail(f"capture failure did not name the program and op: {msg}")
        print(f"(d) a refused capture raises by name: {msg[:160]}",
              flush=True)
    else:
        fail("a capture with .item() inside did not raise")
    torch.cuda.synchronize()


@contextlib.contextmanager
def program_records():
    """The records of every round program built inside the block, kept
    past their programs' lifetimes (a record holds no graph or buffer)."""
    from repro_torch.core import scanloop
    recs, build = [], scanloop.donating_graph

    def recording(*args, **kw):
        prog = build(*args, **kw)
        recs.append(prog.record)
        return prog

    scanloop.donating_graph = recording
    try:
        yield recs
    finally:
        scanloop.donating_graph = build


def programs_phase(x):
    """The ``programs`` phase: (a), (b), the audit of the main path's
    programs (every one that ran outside ``uncaptured()`` captured, none
    with a host function or streaming, at least one admitted to the
    cache), (e), (c) and (d)."""
    from repro_torch.core import scanloop
    fns = prog_fl_setup(x)
    with program_records() as main:
        t = time.perf_counter()
        check_case_study_programs()
        print(f"(a) case study: {time.perf_counter() - t:.2f} s", flush=True)
        t = time.perf_counter()
        probe, _ = fl_pass(x, fns, prog_engine(None, "static"), -1.0,
                           PROG["fl_chunk"], PROG["fl_rounds"])
        thr = probe["history"][2] * 0.999
        launches = check_fl_programs(x, fns, thr)
        print(f"(b) K = {K_POP} drivers: {time.perf_counter() - t:.2f} s",
              flush=True)
    ran = [r for r in main if r.replays or r.why_uncaptured != "uncaptured()"]
    # a program may run eagerly only under the byte rule, and say so
    by_rule = [r for r in ran if r.why_uncaptured == scanloop.OVER_BYTE_CAP]
    bad = [(r.name, r.why_uncaptured, r.host_fns) for r in ran
           if (r.why_uncaptured != scanloop.OVER_BYTE_CAP
               and (not r.captured or r.why_uncaptured))
           or r.host_fns or r.streaming]
    admitted = [r for r in ran if r.cache_key is not None and r.captured]
    if bad or not admitted:
        fail(f"main-path programs not all captured ({bad}) or none admitted "
             f"({len(admitted)})")
    print(f"main path: {len(ran)} programs ran outside uncaptured(), "
          f"{len(ran) - len(by_rule)} captured, {len(by_rule)} eager under "
          f"the byte rule, none with a host function; {len(admitted)} "
          f"admitted to the cache; held bytes {[r.held_bytes for r in ran]}"
          f"; cache {json.dumps(scanloop.cache_stats())} ({SMI})",
          flush=True)
    t = time.perf_counter()
    check_fl_variants(x, fns, thr)
    print(f"(e) variants: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    numbers = time_programs(x, fns)
    print(f"(c) timing: {time.perf_counter() - t:.2f} s", flush=True)
    check_capture_failure()
    print(f"programs numbers {json.dumps(numbers)}", flush=True)
    return {"programs_fl": launches}


# -- paper: the paper's experiments on the port ---------------------------------

PAPER_C1 = dict(t0=2, max_rounds=4, chunks=(1, 4))
PAPER_SWEEP = dict(seeds=1, max_rounds=8, t0_grid=(0, 2, 4))
#: meta rounds timed alone in (c), and meta rounds in its trace
PAPER_META = dict(reps=7, traced=2)


def paper_casestudy(**kw):
    """The case study at full paper-DQN width on the sparse plan, codec
    None (every combine through B2), as the sweep runs it."""
    from repro_torch.rl.casestudy import CaseStudy
    cs = CaseStudy(plan="sparse", inner_steps=10, outer_lr=0.01,
                   device=DEVICE, **kw)
    if cs.engine.plan.kind != "sparse":
        fail(f"paper case study resolved to {cs.engine.plan.kind!r}")
    return cs


def dqn_leaves():
    """Leaves of the full-width paper-DQN (10)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dqn as qmodel
    return len(qmodel.init(get_arch("paper-dqn"), device=DEVICE))


def b2_only(rounds, leaves):
    """The launch counts of a run that computed ``rounds`` FL rounds of a
    ``leaves``-leaf model on the f32 wire: B2 once per leaf per round."""
    return {n: rounds * leaves if n == "consensus_update_pop" else 0
            for n in KERNELS}


def check_paper_c1():
    """(a) ``CaseStudy.run`` with ``r_target=-1e9`` (every task hits in
    round 1), t0 2, max_rounds 4, at chunk 1 and at chunk 4: every task's
    t_i, history and adapted params and the meta history ``==``; B2
    launches 10 × rounds computed (60 / 240), B1 never."""
    t0, max_rounds = PAPER_C1["t0"], PAPER_C1["max_rounds"]
    runs, by_path = {}, {}
    for chunk in PAPER_C1["chunks"]:
        cs = paper_casestudy(r_target=-1e9, chunk=chunk)
        zero_counts()
        t = time.perf_counter()
        res = cs.run(torch.Generator(device=DEVICE).manual_seed(0), t0,
                     max_rounds=max_rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = launch_counts()
        computed = sum(min(-(-r // chunk) * chunk, max_rounds)
                       for r in res.rounds_per_task)
        want = b2_only(computed, dqn_leaves())
        print(f"(a) chunk {chunk}: t_i {res.rounds_per_task}, meta losses "
              f"{res.meta_history}, {computed} FL rounds computed, launches "
              f"{got} (expected {want}); wall_s {wall}", flush=True)
        if res.rounds_per_task != [1] * 6 or got != want:
            fail(f"C1 run at chunk {chunk}: t_i {res.rounds_per_task}, "
                 f"launches {got}, expected [1] * 6 and {want}")
        runs[chunk] = (res, cs.fl_params)
        by_path[f"paper_c1_chunk{chunk}"] = got
    (r1, p1), (r4, p4) = (runs[c] for c in PAPER_C1["chunks"])
    if (r1.rounds_per_task, r1.fl_histories, r1.meta_history) != \
            (r4.rounds_per_task, r4.fl_histories, r4.meta_history) or any(
                not torch.equal(p1[i][k], p4[i][k]) for i in p1 for k in p1[i]):
        fail("CaseStudy.run at chunk 4 differs from chunk 1 (t_i, histories "
             "or adapted params)")
    print("(a) chunk 1 == chunk 4: every task's t_i, history and adapted "
          "params, and the meta history, bit for bit", flush=True)
    return by_path


def check_paper_sweep():
    """(b) The Fig. 4 sweep reduced to 1 seed, grid (0, 2, 4), max_rounds
    8, chunk 8 (it prints each t0's wall and the FL rounds computed beside
    those used): its energies ``==`` ``_add_energies`` recomputed from the
    JSON's mean t_i, B2 launches 10 × rounds computed; then grid (4,)
    alone gives the same t_i at t0 = 4."""
    from repro_torch.kernels import build
    from repro_torch.rl import fig4_tradeoff

    leaves = dqn_leaves()
    out = build.BUILD_ROOT.parent / "results" / "smoke_torch_fig4.json"
    by_path, results = {}, {}
    for name, grid in (("paper_sweep", PAPER_SWEEP["t0_grid"]),
                       ("paper_sweep_subset", PAPER_SWEEP["t0_grid"][-1:])):
        zero_counts()
        t = time.perf_counter()
        res = fig4_tradeoff.run(seeds=PAPER_SWEEP["seeds"],
                                max_rounds=PAPER_SWEEP["max_rounds"],
                                t0_grid=grid, out=str(out), plan="sparse",
                                device=DEVICE)
        wall = time.perf_counter() - t
        got = launch_counts()
        computed = sum(sum(c) for per_seed in
                       res["run"]["rounds_computed"].values()
                       for c in per_seed)
        want = b2_only(computed, leaves)
        data = json.loads(out.read_text())
        recomputed = {"mean_rounds": data["mean_rounds"], "energies": {}}
        fig4_tradeoff._add_energies(recomputed, grid)
        print(f"(b) grid {grid}: t_i {data['rounds']}, {computed} FL rounds "
              f"computed, launches {got} (expected {want}); wall_s {wall}",
              flush=True)
        if data["run"]["plan"] != "sparse" or got != want or \
                data["energies"] != json.loads(json.dumps(
                    recomputed["energies"])):
            fail(f"sweep grid {grid}: plan {data['run']['plan']}, launches "
                 f"{got} (expected {want}), energies {data['energies']} vs "
                 f"recomputed {recomputed['energies']}")
        results[name] = data
        by_path[name] = got
    t0 = str(PAPER_SWEEP["t0_grid"][-1])
    full, sub = results["paper_sweep"], results["paper_sweep_subset"]
    if full["rounds"][t0] != sub["rounds"][t0]:
        fail(f"t_i at t0={t0}: full grid {full['rounds'][t0]}, subset "
             f"{sub['rounds'][t0]}")
    print(f"(b) subset grid == full grid at t0={t0}: t_i {sub['rounds'][t0]}; "
          f"energies == recomputed; {out}", flush=True)
    return by_path


def measure_meta_round():
    """(c) The MAML stage alone: ``CaseStudy.meta_round`` at full width
    (3 meta tasks, 10 inner steps, first order). Wall ms per meta round
    (median of ``PAPER_META['reps']``, a synchronize around each), then
    kernels per meta round and the device's busy share from one
    ``torch.profiler`` trace. A meta round launches no consensus kernel."""
    from torch.profiler import ProfilerActivity, profile

    cs = paper_casestudy()
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    params = cs.init_params(gen)
    params, _ = cs.meta_round(params, gen)               # warm-up
    zero_counts()
    walls = []
    for _ in range(PAPER_META["reps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, m = cs.meta_round(params, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    got = launch_counts()
    n = PAPER_META["traced"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            params, m = cs.meta_round(params, gen)
        torch.cuda.synchronize()
    out, kernels = trace_kernels(prof, "meta_round")
    wall = statistics.median(walls)
    busy = sum(e.get("dur", 0) for e in kernels) / n / 1e3
    loss = float(m["meta_loss"])
    print(f"(c) meta round (3 tasks x 10 inner steps, paper-DQN): wall ms "
          f"median {wall} (min {min(walls)}, max {max(walls)}; {walls}); "
          f"kernels_per_round={len(kernels) / n} device_busy_ms={busy} "
          f"busy_share={busy / wall}; meta loss {loss}; launches {got} "
          f"(trace {out})", flush=True)
    if any(got.values()) or not abs(loss) < float("inf"):
        fail(f"meta round launched {got} or gave meta loss {loss}")
    if kernels:
        top_kernels(kernels, n)
    else:
        print("profiler trace holds no device kernels: device time not "
              "measured", flush=True)
    return {"paper_meta_round": got}


def check_fleet():
    """(d) The twin of ``examples/async_fleet.py`` on the card, forced onto
    the sparse plan (B1 carries every int8 combine): each fleet's rows'
    link and per-agent counts, n_active and joules equal the host replay
    round by round, and the summed joules the replayed bill (``==``); B1
    launches 5 × 12 × 1 leaf. Each fleet's ``scan_rounds`` replays its
    captured round program; the same fleets under ``uncaptured()`` give
    ``==`` params, rows and launches."""
    import numpy as np
    from repro_torch.core import scanloop, topology
    from repro_torch.launch import async_fleet
    from repro_torch.rl.casestudy import delivered_comm_joules

    K, R = async_fleet.K, async_fleet.ROUNDS
    stacked = async_fleet.fleet_params(DEVICE)
    zero_counts()
    fleets = async_fleet.processes()
    captured = []
    for label, agents in fleets:
        eng, mixed, tel = async_fleet.run(agents, label, stacked,
                                          plan="sparse")
        captured.append((mixed, tel.events(live_only=False)))
        if not all(r.captured and r.captures == 1 and r.replays == R - 1
                   for r in eng.program_records()):
            fail(f"fleet {label!r}: scan_rounds programs "
                 f"{eng.program_records()} not captured")
        if eng.plan.kind != "sparse" or not torch.isfinite(mixed["w"]).all():
            fail(f"fleet {label!r}: plan {eng.plan.kind}, params not finite")
        topo = eng.topology
        acts = topology.availability_stream(agents, K, R)
        masks = [topo.adjacency & a[:, None] & a[None, :] for a in acts]
        ev = tel.events(driver="consensus")
        lc = np.asarray(topo.link_class)
        for e, m, a in zip(ev, masks, acts):
            if e["n_active"] != int(a.sum()):
                fail(f"fleet {label!r} round {e['round']}: n_active "
                     f"{e['n_active']} != replay {int(a.sum())}")
            for cls, code in (("sl", topology.SL), ("ul", topology.UL),
                              ("dl", topology.DL)):
                hit = m & (lc == code)
                if e[f"n_{cls}"] != int(hit.sum()) or \
                        e[f"agent_{cls}"] != hit.sum(0).tolist():
                    fail(f"fleet {label!r} round {e['round']} {cls}: row "
                         "counts differ from the host replay")
        # each round's row against that round's replayed bill, and the
        # ledger's sum against the same sum of the replayed bills (Python
        # 3.12's sum() is compensated; a left-to-right += of 12 × 44.8 J
        # lands one ulp away)
        bills = [delivered_comm_joules(topo, [m], tel.energy_params,
                                       eng.codec) for m in masks]
        if len(ev) != R or [e["joules"] for e in ev] != bills or \
                tel.joules(driver="consensus") != sum(bills):
            fail(f"fleet {label!r}: {len(ev)} rows, joules "
                 f"{[e['joules'] for e in ev]} (sum "
                 f"{tel.joules(driver='consensus')}) != replay {bills}")
    got = launch_counts()
    want = {n: len(fleets) * R if n == "quant_consensus_pop" else 0
            for n in KERNELS}
    print(f"(d) {len(fleets)} fleets x {R} rounds, int8 sparse: rows == host "
          f"replay, joules == bill; launches {got} (expected {want})",
          flush=True)
    if got != want:
        fail(f"fleets launched {got}, expected {want}")
    zero_counts()
    with scanloop.uncaptured():
        for (label, agents), (mixed, rows) in zip(fleets, captured):
            _, e_mixed, e_tel = async_fleet.run(agents, label, stacked,
                                                plan="sparse")
            if not same((mixed, rows), (e_mixed,
                                        e_tel.events(live_only=False))):
                fail(f"fleet {label!r}: captured scan_rounds differs from "
                     "uncaptured()")
    if launch_counts() != want:
        fail(f"fleets under uncaptured() launched {launch_counts()}, "
             f"expected {want}")
    print(f"(d) the {len(fleets)} fleets' captured scan_rounds == "
          f"uncaptured() on params, rows and launches ({SMI})", flush=True)
    return {"paper_fleet_int8": got}


# -- mesh: the sharded and distributed plans ------------------------------------

MESH_KS = (4096, 16384)          # the scale benchmark's sharded rows
MESH_N = 2048
MESH_BLOCKS = 4


def mesh_population(K, n=MESH_N, seed=0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return {"w": torch.randn((K, n), generator=g, device=DEVICE)}


def check_mesh_kernels(errs):
    """(a) B1/B2 in their source form, at the sharded plan's shapes (each
    of 4 blocks of K = 16384 ring agents mixing from the (K, 2048)
    population or its int8 / int8:b64 wire) and the distributed plan's
    (one agent mixing M received rows), against their plain versions;
    then the source form's time beside the population form's."""
    from repro_torch.comms import codecs
    from repro_torch.core import consensus, topology
    from repro_torch.kernels import ops, ref

    K = MESH_KS[-1]
    x = mesh_population(K)["w"]
    idx, sig = (torch.as_tensor(a, device=DEVICE) for a in
                consensus.sparse_structure(topology.ring(K).mixing()))
    B = K // MESH_BLOCKS

    def compare(name, got, want, what):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        errs[name] = max(errs[name], err)
        if not torch.isfinite(got.float()).all() or err > F32_TOL:
            fail(f"{name} source form {what}: max |kernel - plain| = {err}")

    for b in range(MESH_BLOCKS):
        blk = slice(b * B, (b + 1) * B)
        compare("consensus_update_pop",
                ops.consensus_update_pop(x[blk], idx[blk], sig[blk], src=x),
                ref.consensus_update_pop_reference(x[blk], idx[blk],
                                                   sig[blk], x),
                f"block {b}")
        for spec in ("int8", "int8:b64"):
            c = codecs.get_codec(spec)
            enc = c.encode_leaf(x)
            q, s = enc["q"], enc["scale"]
            compare("quant_consensus_pop",
                    ops.quant_consensus_pop(x[blk], q[blk], s[blk], idx[blk],
                                            sig[blk], qblock=c.block,
                                            q_src=q, s_src=s),
                    ref.quant_consensus_pop_reference(
                        x[blk], q[blk], s[blk], idx[blk], sig[blk], c.block,
                        q, s), f"block {b} {spec}")
    M = 6
    lanes = torch.arange(M, device=DEVICE)[None, :]
    w = torch.full((1, M), 0.1, device=DEVICE)
    compare("consensus_update_pop",
            ops.consensus_update_pop(x[:1], lanes, w, src=x[1:M + 1]),
            ref.consensus_update_pop_reference(x[:1], lanes, w, x[1:M + 1]),
            "one agent, M = 6 received rows")
    blk = slice(0, B)
    t_src = median_ms(lambda: ops.consensus_update_pop(x[blk], idx[blk],
                                                       sig[blk], src=x))
    t_pop = median_ms(lambda: ops.consensus_update_pop(x, idx, sig))
    print(f"(a) source form == plain version (max err {errs}); B2 on one "
          f"block of {B} rows from the ({K}, {MESH_N}) source "
          f"{t_src} ms, population form over all {K} rows {t_pop} ms",
          flush=True)


def shared_mixing(topo):
    """``topo`` with its uniform Eq.-(6) σ matrix built once and handed to
    every engine built on it: (b) builds 18 engines on one ring, and each
    would otherwise rebuild the (K, K) matrix on the host (1 GiB at
    K = 16384)."""
    mix = topo.mixing()

    class Shared(type(topo)):
        def mixing(self, data_sizes=None, kind="paper", include_self=True):
            if data_sizes is None and kind == "paper" and include_self:
                return mix
            return super().mixing(data_sizes, kind, include_self)

    return Shared(**{f.name: getattr(topo, f.name)
                     for f in dataclasses.fields(topo)})


def check_sharded():
    """(b) The sharded plan (4 blocks) == the sparse plan bit for bit at
    K = 4096 and 16384 on ring, N = 2048: codecs None, int8, int8:b64;
    static, links fading (p = 0.3) and agents asleep (p_active 0.7, τ = 2,
    λ = 0.9); 2 rounds of ``scan_rounds`` each. Counted from 0 per run:
    the sharded rounds launch their kernel 4 × 1 leaf × 2 rounds times and
    the other kernel never. Times one static round of each codec."""
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine

    counts, times = {}, {}
    for K in MESH_KS:
        x = mesh_population(K)
        ring = shared_mixing(topology.ring(K))
        for spec in (None, "int8", "int8:b64"):
            kernel = ("consensus_update_pop" if spec is None
                      else "quant_consensus_pop")
            for proc in ("static",) + DYN_PROCESSES[:2]:
                kw = {} if proc == "static" else dynamic_kw(proc)
                sparse = ConsensusEngine(ring, codec=spec, plan="sparse",
                                         **kw)
                sharded = ConsensusEngine(ring, codec=spec, plan="sharded",
                                          num_blocks=MESH_BLOCKS, **kw)
                want, wst = sparse.scan_rounds(x, rounds=2)
                zero_counts()
                got, gst = sharded.scan_rounds(x, rounds=2)
                torch.cuda.synchronize()
                got_counts = launch_counts()
                n = got_counts[kernel]
                if n != MESH_BLOCKS * len(x) * 2 or sum(
                        got_counts.values()) != n:
                    fail(f"sharded K={K} {spec} {proc}: launches "
                         f"{got_counts}, want {kernel} = {MESH_BLOCKS} x "
                         f"{len(x)} leaf x 2 rounds")
                if any(not torch.equal(got[k], want[k]) for k in x) or (
                        wst is not None and any(
                            not torch.equal(gst[k], wst[k]) for k in x)):
                    fail(f"sharded K={K} {spec} {proc} differs from the "
                         "sparse plan")
                counts[f"mesh_sharded_K{K}_{spec}_{proc}"] = got_counts
                if proc == "static":
                    st = sharded.init_state(x)
                    times[(K, spec)] = (
                        median_ms(lambda: sharded.step(x, st), iters=7),
                        median_ms(lambda: sparse.step(x, st), iters=7))
        del x
        torch.cuda.empty_cache()
    for (K, spec), (t_sh, t_sp) in times.items():
        print(f"(b) K={K} ring N={MESH_N} codec={spec}: sharded "
              f"({MESH_BLOCKS} blocks) == sparse bit for bit (static, "
              f"dropout, async); static round sharded {t_sh} ms, sparse "
              f"{t_sp} ms (median of 7)", flush=True)
    return counts


def check_distributed(cfg):
    """(c) The distributed plan against the sparse plan at K = 256
    small_world(k=4), the paper-DQN's fc1.w width: static and fading,
    codecs None and int8, 2 rounds, within the engine gate (f32) or the
    int-wire tolerance (int8); one launch per leaf per round; its (M, K)
    slot masks drawn on the card == the CPU's; then the distributed
    round's time against the sparse plan's."""
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine

    topo = topology.small_world(K_POP, k=4, seed=1)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = {"fc1.w": stacked_params(cfg, K_POP, gen)["fc1.w"]}
    counts, worst = {}, 0.0
    for spec in (None, "int8"):
        kernel = ("consensus_update_pop" if spec is None
                  else "quant_consensus_pop")
        for proc in ("static", "dropout"):
            kw = {} if proc == "static" else dynamic_kw(proc)
            sparse = ConsensusEngine(topo, codec=spec, plan="sparse", **kw)
            dist_ = ConsensusEngine(topo, codec=spec, plan="distributed",
                                    **kw)
            want, wst = sparse.scan_rounds(x, rounds=2)
            zero_counts()
            got, gst = dist_.scan_rounds(x, rounds=2)
            torch.cuda.synchronize()
            c = launch_counts()
            if c[kernel] != len(x) * 2 or sum(c.values()) != c[kernel]:
                fail(f"distributed {spec} {proc}: launches {c}, want "
                     f"{kernel} = 1 leaf x 2 rounds")
            counts[f"mesh_distributed_{spec}_{proc}"] = c
            for k in x:
                # f32 wire: only the summation order differs; int wire: a
                # round's last-ulp difference can flip a lane of the next
                # round's quantization, so the JAX package's int-wire
                # tolerance (tests/test_engine.py): 3 quantizer steps
                gate = (engine_gate(x[k]) if spec is None
                        else 3.0 * float(x[k].abs().max()) / 127.0)
                for a, b in ((got, want), (gst, wst)):
                    if a is None:
                        continue
                    err = float((a[k] - b[k]).abs().max())
                    if not torch.isfinite(a[k]).all() or err > gate:
                        fail(f"distributed {spec} {proc} {k}: vs sparse "
                             f"{err} > {gate}")
                    worst = max(worst, err / gate)
    eng = ConsensusEngine(topo, plan="distributed", **dynamic_kw("dropout"))
    ts = torch.arange(3, 11)
    if not torch.equal(eng.round_survival(ts.to(DEVICE)).cpu(),
                       eng.round_survival(ts)):
        fail("distributed slot masks drawn on the card differ from the CPU's")
    sparse = ConsensusEngine(topo, plan="sparse")
    dist_ = ConsensusEngine(topo, plan="distributed")
    t_d = median_ms(lambda: dist_.step(x), iters=7)
    t_s = median_ms(lambda: sparse.step(x), iters=7)
    M, H = len(dist_.schedule()), sparse.lane_structure()[0].shape[1]
    print(f"(c) distributed vs sparse at K={K_POP} small_world(k=4) fc1.w: "
          f"max err {worst:.3g} of the gate; slot masks (M={M}, K) of "
          f"rounds 3..10 == the CPU's; round distributed {t_d} ms (M={M} "
          f"slots) vs sparse {t_s} ms (H={H} lanes), median of 7",
          flush=True)
    return counts


def check_nccl_mesh():
    """(d) A process group of world size 1 on NCCL: the sharded plan
    (K = 4096 on ring, one block) and the distributed plan (K = 1) on the
    mesh == the same engines without one, on a masked round, codecs None
    and int8. One rank shows the mesh bookkeeping only: the distributed
    plan at K = 1 has no slot, so no send/recv runs, and the all_gather
    of one rank is a copy. The multi-rank exchanges are held to their
    emulation by the gloo tests on the CPU (tests/test_torch_mesh.py)."""
    from repro_torch.core import topology
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import multichip

    store = Path(__file__).resolve().parent / "build" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    mesh_lib.init_local_group(0, 1, str(store), backend="nccl")
    try:
        mesh = mesh_lib.make_agent_mesh()
        rows = [multichip.parity_case(topo, plan, codec, mesh, DEVICE)
                for codec in (None, "int8")
                for topo, plan in ((topology.ring(MESH_KS[0]), "sharded"),
                                   (topology.full(1), "distributed"))]
    finally:
        mesh_lib.destroy_local_group()
    bad = [r for r in rows if not (r["ok"] and r["bit_equal"])]
    if bad:
        fail(f"NCCL mesh path differs from its emulation: {bad}")
    print("(d) NCCL world size 1: " + "; ".join(
        f"{r['plan']} K={r['K']} codec={r['codec']} mesh == emulation"
        for r in rows) + " (one rank: no send/recv ran and the all_gather "
          "was a copy; multi-rank exchanges are held by the gloo tests "
          "only)", flush=True)


#: part (g) of ``mesh``: chunk, rounds at most, and the rounds of the
#: recorded run that reads the collectives
MESH_FL = dict(chunk=8, max_rounds=12, recorded_rounds=2)
#: part (h): ``scan_rounds`` rounds a call, timed calls a mode, and the
#: populations (K, codec, whether the byte cap is lifted)
MESH_SCAN = dict(rounds=8, reps=3, cases=((8, "int8", False),
                                          (K_POP, "int8", True)))
#: part (i): ``train_federated(mesh=)`` rounds of the == runs, and timed
#: rounds a mode
MESH_TRAIN = dict(rounds=2, timed=3)


@contextlib.contextmanager
def nccl_mesh(name):
    """A one-position agent mesh over an NCCL group of world size 1 (one
    card runs no more), its communicator set up before the block; the
    programs cached in the block are dropped before the group is
    destroyed."""
    from repro_torch.core import scanloop
    from repro_torch.launch import mesh as mesh_lib

    store = Path(__file__).resolve().parent / "build" / name
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    mesh_lib.init_local_group(0, 1, str(store), backend="nccl")
    try:
        # NCCL sets a communicator up at a group's first collective: do it
        # here, outside the timed runs
        torch.distributed.all_reduce(torch.zeros(1, device=DEVICE))
        with scanloop.built_programs() as records:
            yield mesh_lib.make_agent_mesh()
        scanloop.evict_programs(records)
    finally:
        mesh_lib.destroy_local_group()
        torch.cuda.empty_cache()


def held_record(eng, fns):
    """The record of the FL driver's program cached for ``eng`` and the
    run functions ``fns`` (``multichip.fl_functions``)."""
    from repro_torch.core import scanloop
    recs = [r for r in scanloop.registered_programs()
            if r.cache_key is not None and r.cache_key[0] == "fl_chunk"
            and r.cache_key[4] is eng and r.cache_key[2] is fns[0]]
    if len(recs) != 1:
        fail(f"(g) {len(recs)} cached FL programs for one engine")
    return recs[0]


def check_mesh_fl(cfg, smi):
    """(g) The FL driver on a meshed engine at full width, in an NCCL
    group of world size 1: paper-DQN (811,012 params) x K = 256,
    small_world(k=4), the sharded plan with 1 block, links fading with
    p = 0.3. ``multichip.fl_run`` (the gloo tests' FL case at this width:
    ``run_fl_until_scan`` at chunk 8, buffered telemetry, a regression
    pull toward seeded targets with the batches' noise and the stochastic
    rounding from one generator, the hit mid-chunk from a probe run
    without the mesh), on the int8 wire (B1) and the f32 wire (B2). With
    the byte cap lifted the meshed driver's cached program is captured on
    its first call (sampler and target inside, the population gather and
    the disagreement's all-reduces captured with the round) and replayed
    by the second, a hit; both and the same run under ``uncaptured()``
    ``==`` the run without ``mesh=`` (params, t_i, history, the
    generator's final state, every row's exact fields; the disagreement
    within its tolerance); the launches exactly 10 x the rounds computed,
    counted through the replays; ms a round captured and eager, mesh and
    without (the driver call alone, warm: wall, device time, busy share). At the default cap the K = 256 program runs eagerly by
    the byte rule, the second call a hit, the same bits. A 2-round run
    replaying a captured program is recorded: the observer collectives'
    bytes against ``audit_meta()``, and C3 books exactly the calls the
    run must make. One rank exchanges nothing (the gather is a copy); the
    multi-rank runs are held by the gloo tests alone
    (tests/test_torch_mesh_fl.py, tests/test_torch_mesh_programs.py)."""
    from repro_torch.core import scanloop, topology
    from repro_torch.launch import multichip

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    x = stacked_params(cfg, K_POP, gen)
    n = sum(v[0].numel() for v in x.values())
    topo = topology.small_world(K_POP, k=4, seed=1)
    chunk, rounds = MESH_FL["chunk"], MESH_FL["max_rounds"]

    def run(eng, thr, fns):
        zero_counts()
        out = multichip.fl_run(eng, x, thr, chunk=chunk, device=DEVICE,
                               max_rounds=rounds, fns=fns)
        return dict(out, n=launch_counts())

    def drive(eng, fns):
        """``run``'s driver call alone (the same program: the same key)."""
        from repro_torch.core import federated
        from repro_torch.telemetry import Telemetry
        sample, loss, target_fn = fns
        zero_counts()
        federated.run_fl_until_scan(
            loss, x, sample, eng, multichip.FL["lr"], target_fn=target_fn,
            max_rounds=rounds, chunk=chunk, return_state=True,
            generator=torch.Generator(device=DEVICE).manual_seed(
                multichip.GEN_SEED), telemetry=Telemetry())

    counts, report = {}, {}
    with nccl_mesh("nccl_store_fl") as mesh:
        for spec in ("int8", None):
            kernel = ("quant_consensus_pop" if spec == "int8"
                      else "consensus_update_pop")
            on_mesh, alone = multichip.mesh_pair(topo, "sharded", spec, mesh)
            if on_mesh.local_rows != slice(0, K_POP):
                fail(f"(g) mesh engine holds rows {on_mesh.local_rows}")
            thr = multichip.fl_threshold(
                multichip.masked_engine(topo, "sharded", spec, num_blocks=1),
                x, device=DEVICE)
            fns = multichip.fl_functions(K_POP, x, thr, DEVICE)
            with cap_lifted():
                runs = {"mesh captured": run(on_mesh, thr, fns),
                        "mesh replayed": run(on_mesh, thr, fns)}
                # read now: leaving the block puts the program under the
                # byte rule, which frees its graphs
                r = held_record(on_mesh, fns)
                rec = dict(captured=r.captured, host_fns=r.host_fns,
                           in_place=r.in_place, captures=r.captures,
                           replays=r.replays, group_backend=r.group_backend,
                           held_bytes=r.held_bytes,
                           capture_s=r.capture_seconds,
                           collectives_per_replay=dict(
                               r.collectives_per_replay))
                with scanloop.uncaptured():
                    runs["mesh eager"] = run(on_mesh, thr, fns)
                    runs["alone eager"] = run(alone, thr, fns)
                runs["alone captured"] = run(alone, thr, fns)
                computed = multichip.rounds_computed(
                    runs["alone eager"]["rounds"], chunk, rounds)
                # each program warm (captured or eager), the driver call
                # alone timed (no copy to the host): the median of
                # PROG["reps"] calls, then one profiled call
                timing = {}
                for label, eng in (("mesh", on_mesh), ("alone", alone)):
                    timing[f"{label} captured"] = per_round(
                        lambda eng=eng: drive(eng, fns), computed,
                        f"mesh_fl_{spec}_{label}_captured")
                    with scanloop.uncaptured():
                        timing[f"{label} eager"] = per_round(
                            lambda eng=eng: drive(eng, fns), computed,
                            f"mesh_fl_{spec}_{label}_eager")
                rec_fns = multichip.fl_functions(K_POP, x, -1.0, DEVICE)
                R = MESH_FL["recorded_rounds"]
                for _ in range(2):          # capture, then all replays
                    recorded = multichip.fl_run(
                        on_mesh, x, -1.0, chunk=R, device=DEVICE,
                        max_rounds=R, record=True, fns=rec_fns)
            # a program of its own at the default cap: the byte rule
            # decides (int8: predicted from shapes, never captured; f32:
            # measured by its one capture, then freed)
            cap_fns = multichip.fl_functions(K_POP, x, thr, DEVICE)
            stats = scanloop.cache_stats()
            runs["default cap"] = run(on_mesh, thr, cap_fns)
            runs["default cap hit"] = run(on_mesh, thr, cap_fns)
            hits = scanloop.cache_stats()["hits"] - stats["hits"]
            eager_rec = held_record(on_mesh, cap_fns)
            want = runs["alone eager"]
            expect = {k: (len(x) * computed if k == kernel else 0)
                      for k in KERNELS}
            if not 1 < want["rounds"] < chunk:
                fail(f"(g) {spec}: t_i {want['rounds']} is not mid-chunk")
            for label, got in runs.items():
                r = multichip.fl_compare(got, want, slice(0, K_POP),
                                         "sharded")
                if not (r["ok"] and r["bit_equal"] and r["history_equal"]
                        and r["generator_equal"] and r["rows_equal"]
                        and r["n_rows"] == got["rounds"]):
                    fail(f"(g) {spec}: the {label} run differs from the run "
                         f"without a mesh: {r}")
                if got["n"] != expect:
                    fail(f"(g) {spec}: launches of the {label} run "
                         f"{got['n']}, expected {expect} ({computed} "
                         "rounds)")
            if not (rec["captured"] and rec["host_fns"] == ()
                    and rec["in_place"] and rec["captures"] >= 1
                    and rec["replays"] > 0 and rec["group_backend"] == "nccl"
                    and rec["collectives_per_replay"]):
                fail(f"(g) {spec}: the meshed program under the lifted cap "
                     f"was not captured and replayed: {rec}")
            if eager_rec.why_uncaptured != scanloop.OVER_BYTE_CAP \
                    or hits != 1 or eager_rec.eager_calls < computed \
                    or eager_rec.captures > (spec is None):
                fail(f"(g) {spec}: at the default cap the K = {K_POP} "
                     f"program is {eager_rec.why_uncaptured!r}, {hits} hits")
            counts[f"mesh_fl_{spec}"] = runs["mesh replayed"]["n"]
            ledger, c3 = multichip.fl_ledger(recorded,
                                             f"smoke:mesh_fl/{spec}")
            obs = {o["quantity"]: o["bytes"]
                   for o in recorded["meta"]["observer_collectives"]}
            if c3 or ledger.observer_calls != recorded["observer_calls"]:
                fail(f"(g) {spec}: collectives {ledger} vs observers {obs}: "
                     f"{[f.message for f in c3]}")
            ms = {k: v["wall"] * 1e3 / computed for k, v in runs.items()}
            timed_ms = {k: (v["wall_ms_per_round"], v["device_ms_per_round"],
                            v["busy_share"]) for k, v in timing.items()}
            report[spec or "f32"] = dict(
                t_i=want["rounds"], rounds_computed=computed,
                launches=runs["mesh replayed"]["n"][kernel],
                one_run_ms_per_round=ms, timed=timing, program=rec,
                default_cap=eager_rec.why_uncaptured,
                default_cap_captures=eager_rec.captures,
                over_cap_bytes=eager_rec.over_cap_bytes,
                observer_bytes_per_call=obs,
                wire_bytes_per_round=ledger.wire_bytes / R)
            print(f"(g) {smi}: run_fl_until_scan K={K_POP} paper-dqn "
                  f"({n} params) small_world sharded 1 block, fading, "
                  f"codec={spec}, a generator: mesh captured (sampler and "
                  f"target inside, host_fns {rec['host_fns']}), replayed on "
                  f"the hit, and uncaptured() == without a mesh (params, "
                  f"t_i {want['rounds']}, history, generator, rows); "
                  f"{kernel} {expect[kernel]} = 10 x {computed} rounds on "
                  f"every run; ms a round (wall, device, busy; median of "
                  f"{PROG['reps']} warm driver calls) "
                  + ", ".join(f"{k} {w:.3f} / {d:.3f} / {b:.3f}"
                              for k, (w, d, b) in timed_ms.items())
                  + "; one run each "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                  + f"; program {rec}; default cap: "
                  f"{eager_rec.why_uncaptured} ({eager_rec.over_cap_bytes}"
                  f" B, {eager_rec.captures} captures), then {hits} hit; "
                  f"recorded replays: C3 clean, observer "
                  f"calls {ledger.observer_calls}, per call: population "
                  f"gather {obs['population for target_fn']} B, "
                  f"all-reduces {obs['disagreement column sums']} + "
                  f"{obs['disagreement distances']} B", flush=True)
            del runs, recorded, rec, eager_rec
            torch.cuda.empty_cache()
    print(f"(g) numbers {json.dumps(report)}", flush=True)
    return counts


def profiled_names(fn):
    """The device events of one profiled call of ``fn``: (kernels, the
    names of the events a collective left: NCCL kernels, or the copies an
    NCCL group of one rank makes instead)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    return len(names), sorted({n for n in names if "nccl" in n.lower()
                               or "memcpy" in n.lower()})


def check_mesh_scan(cfg, smi):
    """(h) ``scan_rounds`` on a meshed engine, in an NCCL group of world
    size 1: paper-DQN width, small_world(k=4), the sharded plan with 1
    block, the int8 wire (B1), links fading with p = 0.3, a generator,
    buffered telemetry; at K = 8 (below the byte cap) and at K = 256
    with the cap lifted. The engine's held round program is captured by
    the first call and replayed by the next; each call ``==`` the same
    call under ``uncaptured()`` and the engine without a mesh (params,
    EF state, generator, rows but their disagreement, which sums in
    another order); B1 10 a round through the replays; ms a round
    captured and eager (median of ``MESH_SCAN["reps"]`` calls each),
    held bytes, and the collectives' device events by name in a profiled
    replay (on one rank NCCL copies; it launches no kernel)."""
    from repro_torch.core import scanloop, topology
    from repro_torch.launch import multichip
    from repro_torch.telemetry import Telemetry

    R = MESH_SCAN["rounds"]
    report, counts = {}, {}
    with nccl_mesh("nccl_store_scan") as mesh:
        for K, spec, lifted in MESH_SCAN["cases"]:
            gen = torch.Generator(device=DEVICE).manual_seed(9)
            x = stacked_params(cfg, K, gen)
            topo = topology.small_world(K, k=4, seed=1)
            on_mesh, alone = multichip.mesh_pair(topo, "sharded", spec, mesh)

            def run(eng):
                tel = Telemetry()
                g = torch.Generator(device=DEVICE).manual_seed(1)
                zero_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                p, st = eng.scan_rounds(x, rounds=R, generator=g,
                                        telemetry=tel)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3 / R
                rows = tel.events(live_only=False)
                return dict(out=(p, st, g.get_state()), rows=rows,
                            bare=[{k: v for k, v in e.items()
                                  if k != "disagreement"} for e in rows],
                            n=launch_counts(), ms=ms)

            ctx = cap_lifted() if lifted else contextlib.nullcontext()
            with ctx:
                cap = [run(on_mesh) for _ in range(1 + MESH_SCAN["reps"])]
                names = profiled_names(lambda: run(on_mesh))
                with scanloop.uncaptured():
                    eager = [run(on_mesh)
                             for _ in range(1 + MESH_SCAN["reps"])]
                ref = run(alone)
                # read before a lifted cap returns: the byte rule would
                # free the graphs
                (r,) = on_mesh.program_records()
                rec = dataclasses.replace(r, collectives_per_replay=dict(
                    r.collectives_per_replay))
            want = {k: (len(x) * R if k == "quant_consensus_pop" else 0)
                    for k in KERNELS}
            for label, got in [("captured", c) for c in cap] + [
                    ("eager", e) for e in eager]:
                if not (same(got["out"], eager[0]["out"])
                        and got["rows"] == eager[0]["rows"]
                        and same(got["out"], ref["out"])
                        and got["bare"] == ref["bare"]
                        and got["n"] == want):
                    fail(f"(h) K={K}: a {label} call differs from "
                         f"uncaptured() or the engine without a mesh, or "
                         f"launches {got['n']} != {want}")
            if not (rec.captured and rec.captures == 1 and rec.in_place
                    and rec.replays == R * (1 + MESH_SCAN["reps"] + 1) - 1):
                fail(f"(h) K={K}: the held program was not captured once "
                     f"and replayed: {rec}")
            ms_cap = statistics.median(c["ms"] for c in cap[1:])
            ms_eager = statistics.median(e["ms"] for e in eager[1:])
            counts[f"mesh_scan_{K}"] = cap[-1]["n"]
            report[K] = dict(ms_per_round_captured=ms_cap,
                             ms_per_round_eager=ms_eager,
                             first_call_ms_per_round=cap[0]["ms"],
                             held_bytes=rec.held_bytes,
                             capture_s=rec.capture_seconds,
                             collectives_per_replay=rec.collectives_per_replay,
                             device_events=names[0],
                             collective_events=names[1], lifted=lifted)
            print(f"(h) {smi}: scan_rounds K={K} paper-dqn sharded 1 block "
                  f"{spec} fading, buffered telemetry, mesh: captured "
                  f"{ms_cap:.3f} ms a round, eager {ms_eager:.3f} "
                  f"(first call {cap[0]['ms']:.3f}; cap "
                  f"{'lifted' if lifted else 'default'}), == uncaptured() "
                  f"== without a mesh, B1 {want['quant_consensus_pop']}; "
                  f"held {rec.held_bytes} B; collectives a replay "
                  f"{rec.collectives_per_replay}; in a profiled replay "
                  f"{names[0]} device events, the collectives' "
                  f"{names[1] or 'none named'} (one rank: NCCL copies)",
                  flush=True)
            del x, on_mesh, alone, cap, eager, ref, rec
            torch.cuda.empty_cache()
    print(f"(h) numbers {json.dumps(report)}", flush=True)
    return counts


def check_mesh_train(smi):
    """(i) ``train_federated(mesh=)`` in an NCCL group of world size 1:
    granite-8b at full width and 2 layers, 4 agents in 2 tasks, the
    sharded plan with 1 block, codec None (B2), buffered telemetry (the
    shape of ``train_lm``'s ``measure_fl_round``), ``MESH_TRAIN["rounds"]``
    rounds: its round program captured and replayed ``==`` the run under
    ``uncaptured()`` and the run without ``mesh=`` (population, losses,
    rows but their disagreement), B2 12 and B4 34 a round through the
    replays; the collectives a recorder reads of the captured run ``==``
    the uncaptured run's, and C3 books the rows' all-reduces and the
    logged loss's broadcast exactly. Then the meshed round program alone:
    ms a round captured and eager (median of ``MESH_TRAIN["timed"]``),
    peak allocated and reserved GB."""
    from repro_torch import telemetry
    from repro_torch.analysis import costmodel
    from repro_torch.core import scanloop, topology
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.data import TaskTokenDistribution
    from repro_torch.launch import train
    from repro_torch.models.api import lm_loss

    cfg = train_cfg()
    A, T, S = (TRAIN_FED["agents"], TRAIN_FED["tasks"],
               TRAIN_FED["local_steps"])
    rounds = MESH_TRAIN["rounds"]
    kw = dict(TRAIN_FED, rounds=rounds)
    out = {}
    with nccl_mesh("nccl_store_train") as mesh:
        runs = {}
        for label, m, ctx in (
                ("captured", mesh, contextlib.nullcontext()),
                ("eager", mesh, scanloop.uncaptured()),
                ("without a mesh", None, contextlib.nullcontext())):
            tel = telemetry.Telemetry()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            with ctx, costmodel.CollectiveRecorder() as rec, \
                    scanloop.built_programs() as recs:
                p, hist, _, _ = train.train_federated(
                    cfg, consensus_plan="sharded", mesh=m, telemetry=tel,
                    device=DEVICE, return_state=True, **kw)
            torch.cuda.synchronize()
            rows = tel.events(live_only=False)
            runs[label] = dict(
                host=to_host(p), hist=hist, rows=rows,
                bare=[{k: v for k, v in e.items() if k != "disagreement"}
                      for e in rows], n=launch_counts(),
                records=list(rec.records), recs=recs,
                peak=torch.cuda.max_memory_allocated() / 1e9,
                reserved=torch.cuda.max_memory_reserved() / 1e9)
            del p
        cap, eag, ref = (runs["captured"], runs["eager"],
                         runs["without a mesh"])
        want = fed_expected(cfg, "consensus_update_pop", rounds=rounds)
        (prog,) = cap["recs"]
        same_pop = all(torch.equal(cap["host"][k], v) and
                       torch.equal(ref["host"][k], v)
                       for k, v in eag["host"].items())
        eng = ConsensusEngine(topology.clusters(T, A // T), mesh=mesh,
                              plan="sharded")
        meta = eng.audit_meta({k: v[0] for k, v in cap["host"].items()})
        ledger, c3 = costmodel.collective_ledger(
            meta, cap["records"], "smoke:mesh_train",
            costmodel.observer_calls(0, rounds, losses=rounds))
        if not (same_pop and cap["hist"] == eag["hist"] == ref["hist"]
                and cap["rows"] == eag["rows"] and cap["bare"] == ref["bare"]
                and cap["n"] == eag["n"] == ref["n"] == want
                and cap["records"] == eag["records"] and not c3
                and prog.captures == 1 and prog.replays == rounds - 1
                and prog.in_place):
            fail(f"(i) train_federated(mesh=): captured == uncaptured "
                 f"{same_pop and cap['hist'] == eag['hist']}, == without a "
                 f"mesh {cap['hist']} / {ref['hist']}, launches {cap['n']} / "
                 f"{eag['n']} / {ref['n']} (want {want}), records equal "
                 f"{cap['records'] == eag['records']}, C3 "
                 f"{[f.message for f in c3]}, program {prog}")
        print(f"(i) {smi}: train_federated(mesh=) {cfg.name} width "
              f"{cfg.d_model} layers {cfg.num_layers}, {A} agents, {T} "
              f"tasks, sharded 1 block, codec None, {rounds} rounds: "
              f"captured == uncaptured() == without mesh= (population, "
              f"losses {cap['hist']}, rows), launches {cap['n']}; recorded "
              f"collectives captured == uncaptured ({len(cap['records'])}), "
              f"observer calls {ledger.observer_calls}; peak alloc / "
              f"reserved GB captured {cap['peak']:.2f} / "
              f"{cap['reserved']:.2f}, eager {eag['peak']:.2f} / "
              f"{eag['reserved']:.2f}, without a mesh {ref['peak']:.2f} / "
              f"{ref['reserved']:.2f}", flush=True)
        out.update(launches=cap["n"], peak_GB={k: (v["peak"], v["reserved"])
                                               for k, v in runs.items()})
        del runs, cap, eag, ref
        torch.cuda.empty_cache()

        # the meshed round program alone, timed
        engine = ConsensusEngine(topology.clusters(T, A // T), mesh=mesh,
                                 plan="sharded")
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        params = train.init_params(cfg, gen, DEVICE)
        st = {"c": ({k: v.expand((A,) + v.shape).clone()
                     for k, v in params.items()}, None, None, None)}
        del params
        dist = TaskTokenDistribution(vocab_size=cfg.vocab_size, num_tasks=T)
        grid = (torch.arange(A, device=DEVICE) // (A // T))[:, None].expand(
            A, S)

        def loss_fn(p, tokens, labels):
            return lm_loss(p, cfg, tokens, labels)

        prog = train.federated_round_program(
            engine, loss_fn, dist, grid, batch=TRAIN_FED["batch"],
            seq=TRAIN_FED["seq"], lr=TRAIN_FED["lr"])
        xs = {"t": torch.zeros((), dtype=torch.int64, device=DEVICE),
              "link": None, "act": None}

        def one():
            (st["c"],), _ = prog(st["c"], xs, gen)

        def timed():
            torch.cuda.reset_peak_memory_stats()
            one()                 # warm; captured: its call and capture
            torch.cuda.synchronize()
            walls = []
            for _ in range(MESH_TRAIN["timed"]):
                t = time.perf_counter()
                one()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            return dict(ms_per_round=statistics.median(walls),
                        walls_ms=walls,
                        peak_GB=torch.cuda.max_memory_allocated() / 1e9,
                        reserved_GB=torch.cuda.max_memory_reserved() / 1e9)

        with scanloop.uncaptured():
            out["eager"] = timed()
        out["captured"] = timed()
        out["captured"].update(capture_s=prog.record.capture_seconds,
                               held_bytes=prog.record.held_bytes,
                               collectives_per_replay=(
                                   prog.record.collectives_per_replay))
        print(f"(i) {smi}: the meshed round program ({A} agents x {S} "
              f"local steps, batch {TRAIN_FED['batch']} x "
              f"{TRAIN_FED['seq']}): captured {out['captured']}; eager "
              f"{out['eager']}", flush=True)
        del st, prog
    torch.cuda.empty_cache()
    print(f"(i) numbers {json.dumps(out)}", flush=True)
    return {"mesh_train_federated": out.pop("launches")}


def check_h1():
    """(e) One masked sharded round at K = 16384, N = 2048 adds at most
    4x the population's f32 bytes to the peak allocation (no (K, K)
    buffer: one would be 1 GiB), codecs None and int8."""
    from repro_torch.launch import multichip

    for codec in (None, "int8"):
        r = multichip.h1_memory(codec=codec, device=DEVICE)
        print(f"(e) masked sharded round K={r['K']} N={r['n_params']} "
              f"codec={codec}: peak added {r['added_bytes']} B <= "
              f"{r['bound_bytes']} B (a (K, K) f32 buffer is "
              f"{r['kk_f32_bytes']} B)", flush=True)


def run_scale_smoke():
    """(f) The scale benchmark's ``--smoke`` sections and gates on the
    card (``repro_torch.launch.consensus_scale``)."""
    from repro_torch.launch import consensus_scale

    out = Path(__file__).resolve().parent / "build" / "results" / \
        "torch_consensus_scale_smoke.json"
    payload = consensus_scale.run(smoke=True, device=DEVICE, out=str(out))
    loop, tel = payload["rounds_loop"], payload["telemetry_rows"]
    print(f"(f) consensus_scale --smoke: gates held (chunk 32 "
          f"{loop[-1]['us_per_round']:.1f} vs chunk 1 "
          f"{loop[0]['us_per_round']:.1f} us/round; buffered telemetry "
          f"{tel[1]['overhead_vs_off']:.3f}x off); {out}", flush=True)


def trace_kernels(prof, name):
    """Export ``prof``'s trace to ``build/profile/<name>.json`` beside the
    kernels; return its path and its device-kernel events."""
    from repro_torch.kernels import build
    out = build.BUILD_ROOT.parent / "profile" / f"{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    return out, [e for e in events if e.get("cat") == "kernel"]


def top_kernels(kernels, per, n=6):
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0) + e.get("dur", 0)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]:
        print(f"  {us / per / 1e3:.4f} ms  {name[:90]}", flush=True)


def profile_round(rounds=3):
    """Where one case-study FL round spends its time (int8 wire, sparse
    plan): host wall per round without the profiler, then device kernel
    time per round from a ``torch.profiler`` trace of the same rounds.
    The trace goes to ``build/profile/`` beside the kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.rl.casestudy import CaseStudy

    cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                   codec="int8", device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    C = cs.network.devices_per_cluster
    stacked = {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
               for k, v in cs.init_params(gen).items()}
    state = cs.engine.init_state(stacked)

    def run():
        nonlocal stacked, state
        for _ in range(rounds):
            stacked, state, _ = cs.fl_round(0, stacked, state, gen)
        torch.cuda.synchronize()

    run()                                            # warm-up
    t = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t) / rounds * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    out, kernels = trace_kernels(prof, "casestudy_fl_round")
    busy_ms = sum(e.get("dur", 0) for e in kernels) / rounds / 1e3
    cons_ms = sum(e.get("dur", 0) for e in kernels
                  if "consensus_pop_kernel" in e.get("name", "")
                  ) / rounds / 1e3
    print(f"FL round (2 robots, int8, sparse): wall_ms={wall_ms} "
          f"kernels_per_round={len(kernels) / rounds} "
          f"device_busy_ms={busy_ms} busy_share={busy_ms / wall_ms} "
          f"consensus_kernels_ms={cons_ms} (trace {out})", flush=True)
    if not kernels:
        print("profiler trace holds no device kernels: device time "
              "not measured", flush=True)
        return
    top_kernels(kernels, rounds)


def visible_pairs(S, T, causal, window):
    """(query, key) pairs the masks leave visible, positions from 0:
    ``repro_torch.kernels.work.visible_pairs``, held to the smoke's
    earlier count."""
    from repro_torch.kernels import work

    q = torch.arange(S, dtype=torch.int64)
    hi = torch.minimum(q, torch.tensor(T - 1)) if causal else \
        torch.full_like(q, T - 1)
    lo = (q - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(q)
    old = int((hi - lo + 1).clamp(min=0).sum())
    return same_work("visible_pairs",
                     (work.visible_pairs(S, T, causal, window), 0), (old, 0))[0]


def b4_work(q, k, causal, window, old):
    """B4's (bytes, flops) for q over k from ``kernels/work.py``, held to
    the smoke's earlier count ``old``."""
    from repro_torch.kernels import work

    B, S, H, hd = q.shape
    return same_work("flash_attention", work.flash_attention(
        B, S, k.shape[1], H, k.shape[2], hd, causal=causal, window=window,
        elem=q.element_size()), old)


def check_lm_kernels(cfg, generator):
    """B3 and B4 against their plain versions on the card at the serving
    shapes, then their times and bounds there."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, work

    Bs, S = SERVE["batch"], SERVE["prompt_len"]
    W, H, K, hd = (cfg.rglru.lru_width, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim_)
    window, softcap = cfg.sliding_window, cfg.logit_softcap

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=generator, device=DEVICE).to(dtype)

    # B3 at the prefill's shape: f32 (B, T, W), decays like the model's
    log_a = -8.0 * F.softplus(randn(W) - 6.0) * torch.sigmoid(randn(Bs, S, W))
    b = randn(Bs, S, W)
    h0 = randn(Bs, W)
    h, hl = ops.rglru_scan(log_a, b, h0)
    wh, whl = ref.rglru_scan_reference(log_a, b, h0)
    torch.cuda.synchronize()
    b3_abs = max(float((h - wh).abs().max()), float((hl - whl).abs().max()))
    b3_rel = max(float(((h - wh).abs() / wh.abs().clamp(min=1)).max()),
                 float(((hl - whl).abs() / whl.abs().clamp(min=1)).max()))
    print(f"rglru_scan ({Bs}, {S}, {W}) f32 with h0: max |kernel - plain| = "
          f"{b3_abs}, max |d|/max(1,|plain|) = {b3_rel} (gate {B3_TOL})",
          flush=True)
    if not torch.isfinite(h).all() or b3_rel > B3_TOL:
        fail(f"rglru_scan: {b3_rel} > {B3_TOL}")

    # B4 at the serving shape (B = 1 for the plain version's O(S·T)
    # scores) in bf16: randn q gives scores of std 1, q x 20 scores of std
    # 20 that the softcap bends; a ragged bf16 case (S, T not tile
    # multiples, hd 120, a window whose edge cuts kv tiles); and a ragged
    # f32 case
    b4_err = 0.0
    for dtype, qscale, (B, Sq, Hq, Kq, d, win, cap) in (
            (torch.bfloat16, 1.0, (1, S, H, K, hd, window, softcap)),
            (torch.bfloat16, 20.0, (1, S, H, K, hd, window, softcap)),
            (torch.bfloat16, 1.0, (1, 1000, 8, 2, 120, 300, softcap)),
            (torch.float32, 1.0, (1, 1000, 8, 2, 120, 0, 0.0))):
        q, k, v = (randn(B, Sq, n, d, dtype=dtype) for n in (Hq, Kq, Kq))
        q = (q.float() * qscale).to(dtype)
        kw = dict(causal=True, window=win, softcap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.attention_reference(q, k, v, **kw)
        diff = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            pv = ref.attention_reference(q.float(), k.float(),
                                         v.float().abs(), **kw)
            gate = (B4_BF16_REL * want.float().abs() + B4_BF16_PV * pv
                    + B4_BF16_ABS)
            rms = float(want.float().square().mean().sqrt())
            what = (f"2^-7 |plain| + 2^-8 P|v| + {B4_BF16_ABS} gate; typical "
                    f"|plain| (rms) {rms}")
            del pv
        else:
            gate = B4_F32_TOL + B4_F32_TOL * want.float().abs()
            what = f"{B4_F32_TOL} abs+rel gate"
        torch.cuda.synchronize()
        worst = float((diff / gate).max())
        err = float(diff.max())
        b4_err = max(b4_err, err)
        print(f"flash_attention {tuple(q.shape)} kv {tuple(k.shape)} {dtype} "
              f"q x {qscale} window={win} softcap={cap}: max |kernel - plain| "
              f"= {err}, {worst:.4g} of the {what}", flush=True)
        if not torch.isfinite(got.float()).all() or worst > 1.0:
            fail(f"flash_attention {dtype} q x {qscale}: beyond its gate")
        del q, k, v, got, want, diff, gate

    rows = {}
    # B3 times: inputs read once (2 x 4 B), output written (4 B) per
    # element, h0 and h_last rows; exp + mul + add per element
    n = Bs * S * W
    b3 = bound(*same_work("rglru_scan", work.rglru_scan(Bs, S, W,
                                                        with_h0=True),
                          (12 * n + 8 * Bs * W, 3 * n)))
    t3 = (median_ms(lambda: ops.rglru_scan(log_a, b, h0)),
          median_ms(lambda: ref.rglru_scan_reference(log_a, b, h0)))
    print(f"rglru_scan ({Bs}, {S}, {W}) f32: kernel_ms={t3[0]} plain_ms="
          f"{t3[1]} library_ms=None bound_ms={b3[0]} ({b3[1]})", flush=True)
    rows["rglru_scan"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:46", max_abs_err=b3_abs,
        ms=t3[0], plain_ms=t3[1], bound_ms=b3[0], bound_by=b3[1],
        library_ms=None)
    del log_a, b, h0, h, hl, wh, whl

    # B4 times at the serving shape, bf16: q, k, v read and out written
    # once; 4·hd flops per visible (query, key) pair per (batch, q head)
    q, k, v = (randn(Bs, S, n_, hd, dtype=torch.bfloat16) for n_ in (H, K, K))
    pairs = visible_pairs(S, S, True, window)
    flops = 4 * hd * pairs * Bs * H
    b4 = bound(*b4_work(q, k, True, window,
                        (2 * (2 * q.numel() + k.numel() + v.numel()), flops)),
               BF16_FLOPS_PER_S)
    kw = dict(causal=True, window=window, softcap=softcap)
    t_kernel = median_ms(lambda: ops.flash_attention(q, k, v, **kw))
    t_cap0 = median_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                   window=window))
    t_plain = median_ms(lambda: ref.attention_reference(q, k, v, **kw))
    # library yardstick: SDPA at softcap 0 with the same causal + window
    # boolean mask (kv heads expanded for MQA); never called by the port
    pos = torch.arange(S, device=DEVICE)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).expand(Bs, H, S, hd) for t in (k, v))
    t_lib = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    print(f"flash_attention q {tuple(q.shape)} kv {tuple(k.shape)} bf16 "
          f"window={window} softcap={softcap}: kernel_ms={t_kernel} "
          f"(softcap 0: {t_cap0}) plain_ms={t_plain} library_ms(SDPA, "
          f"softcap 0)={t_lib} bound_ms={b4[0]} ({b4[1]}); visible pairs "
          f"per (b, h) {pairs}; achieved {flops / t_kernel / 1e9} TFLOP/s "
          f"(softcap 0: {flops / t_cap0 / 1e9}) against the bound's "
          f"{BF16_FLOPS_PER_S / 1e12}", flush=True)
    for name in ("rglru_scan", "flash_attention", "flash_attention_bwd"):
        print(f"ptxas {name}.cu: {ptxas_summary(name)}", flush=True)
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98", max_abs_err=b4_err,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b4[0], bound_by=b4[1],
        library_ms=t_lib)
    return rows


#: ROADMAP C11: the JAX package's attention gradient at q = k = v (1,
#: 4096, 4, 64) f32, causal: the temporaries of
#: ``jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v)), argnums=(0, 1,
#: 2))).lower(...).compile().memory_analysis()`` on the CPU (jax 0.9.0),
#: in MB. Its model attention takes ``attention_chunked`` at this length;
#: both are O(S·T) (the scan's VJP keeps every kv chunk's residuals)
C11_SHAPE = (1, 4096, 4, 64)
C11_REF_TEMP_MB = {"attention_chunked": 804.2, "attention_reference": 1350.6}
#: B4's backward peak may exceed the chunked scan's temporaries by this
#: factor at most: beyond it, B4's gradient would need the chunked form
C11_MAX_RATIO = 3.0


def check_b4_backward_memory(generator):
    """B4's forward and backward (B4′, one launch each) at ``C11_SHAPE``
    f32, causal: the peak
    allocation above the inputs against the JAX package's compiled
    gradient temporaries (``C11_REF_TEMP_MB``), on a line of its own: the
    ``kernels`` line holds only this run's measurements."""
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    q, k, v = (torch.randn(C11_SHAPE, generator=generator, device=DEVICE)
               .requires_grad_() for _ in range(3))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=0)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    after = launch_counts()
    launched, launched_bwd = (after[n] - before[n] for n in (
        "flash_attention", "flash_attention_backward"))
    B, S, H, _ = C11_SHAPE
    st_mb = B * H * S * S * 4 / 1e6
    k_ratio = peak_mb / C11_REF_TEMP_MB["attention_chunked"]
    measured = dict(shape=list(C11_SHAPE), dtype="float32", causal=True,
                    backward_peak_mb=peak_mb, one_bhst_f32_mb=st_mb,
                    peak_in_bhst=peak_mb / st_mb, launches=launched,
                    backward_launches=launched_bwd)
    print(f"flash_attention backward memory (C11), measured: "
          f"{json.dumps(measured)}; against the JAX package's compiled "
          f"temporaries {C11_REF_TEMP_MB} MB (CPU constants, not this run's):"
          f" k = {k_ratio} vs chunked, "
          f"{peak_mb / C11_REF_TEMP_MB['attention_reference']} vs einsum",
          flush=True)
    if launched != 1 or launched_bwd != 1 or k_ratio > C11_MAX_RATIO \
            or not all(torch.isfinite(g).all() for g in grads):
        fail(f"flash_attention backward memory: k = {k_ratio} (limit "
             f"{C11_MAX_RATIO}), launches B4 {launched}, B4′ {launched_bwd}")
    del q, k, v, out, grads
    torch.cuda.empty_cache()


def check_b4_transformer_shapes(generator):
    """B4 against its plain version at h2o-danube-3-4b's and
    qwen2-moe-a2.7b's prefill shapes (bf16, softcap 0; the plain version
    at batch 1 for its O(S·T) scores, under the bf16 rounding gate), then
    kernel, plain-version and SDPA times and the bound at batch 4. SDPA
    gets kv heads repeated to H outside the timed call, and ``is_causal``
    where the window cuts nothing (danube's 4096 at S = 4096) or the
    boolean causal + window mask where it does. Returns the numbers by
    arch and the largest error."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref

    Bs, S = SERVE["batch"], SERVE["prompt_len"]

    def randn(*shape):
        return torch.randn(*shape, generator=generator,
                           device=DEVICE).to(torch.bfloat16)

    out, err = {}, 0.0
    for arch in LM_ARCHS:
        cfg = get_arch(arch)
        H, K, hd, window = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                            cfg.sliding_window)
        kw = dict(causal=True, window=window, softcap=cfg.logit_softcap)
        q, k, v = (randn(1, S, n, hd) for n in (H, K, K))
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.attention_reference(q, k, v, **kw)
        pv = ref.attention_reference(q.float(), k.float(), v.float().abs(),
                                     **kw)
        diff = (got.float() - want.float()).abs()
        gate = B4_BF16_REL * want.float().abs() + B4_BF16_PV * pv \
            + B4_BF16_ABS
        torch.cuda.synchronize()
        worst, e = float((diff / gate).max()), float(diff.max())
        err = max(err, e)
        print(f"flash_attention {arch} q {tuple(q.shape)} kv {tuple(k.shape)} "
              f"bf16 window={window}: max |kernel - plain| = {e}, "
              f"{worst:.4g} of the bf16 rounding gate", flush=True)
        if not torch.isfinite(got.float()).all() or worst > 1.0:
            fail(f"flash_attention at {arch}'s shape: beyond its gate")
        del q, k, v, got, want, pv, diff, gate

        q, k, v = (randn(Bs, S, n, hd) for n in (H, K, K))
        pairs = visible_pairs(S, S, True, window)
        flops = 4 * hd * pairs * Bs * H
        b4 = bound(*b4_work(q, k, True, window,
                            (2 * (2 * q.numel() + k.numel() + v.numel()),
                             flops)), BF16_FLOPS_PER_S)
        t_kernel = median_ms(lambda: ops.flash_attention(q, k, v, **kw))
        t_plain = median_ms(lambda: ref.attention_reference(q, k, v, **kw))
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(H // K, dim=1)
                  for t in (k, v))
        if 0 < window < S:
            pos = torch.arange(S, device=DEVICE)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            sdpa = dict(attn_mask=mask)
        else:
            sdpa = dict(is_causal=True)
        t_lib = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa))
        print(f"flash_attention {arch} q {tuple(q.shape)} kv {tuple(k.shape)} "
              f"bf16 window={window}: kernel_ms={t_kernel} plain_ms={t_plain} "
              f"library_ms(SDPA)={t_lib} bound_ms={b4[0]} ({b4[1]}); "
              f"{flops:.4g} flop, achieved {flops / t_kernel / 1e9} TFLOP/s",
              flush=True)
        out[arch] = dict(shape=[list(q.shape), list(k.shape)], max_abs_err=e,
                         ms=t_kernel, plain_ms=t_plain, bound_ms=b4[0],
                         bound_by=b4[1], library_ms=t_lib)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out, err


def expected_prefill(cfg):
    """B3/B4 launches of one prefill: B3 once per recurrent layer, B4 once
    per attention (every layer of a transformer; whisper's encoder layers
    once, its decoder layers twice; none in xLSTM)."""
    want = {n: 0 for n in KERNELS}
    if cfg.family == "hybrid":
        from repro_torch.models import rglru
        types = rglru.layer_types(cfg)
        return dict(want, rglru_scan=types.count("recurrent"),
                    flash_attention=types.count("attention"))
    if cfg.family == "ssm":
        return want
    if cfg.family == "encdec":
        # the encoder's unmasked self-attention, then each decoder layer's
        # causal self-attention and its cross-attention over the frames
        return dict(want, flash_attention=cfg.encdec.num_encoder_layers
                    + 2 * cfg.num_layers)
    return dict(want, flash_attention=cfg.num_layers)


def uncounted_params(cfg):
    """What ``param_count()`` leaves out, as the JAX package's formula
    does: the shared expert's gate (d per layer) and the q/k norms (2·hd
    per layer)."""
    shared = cfg.d_model if cfg.moe is not None and \
        cfg.moe.num_shared_experts else 0
    return cfg.num_layers * (shared + (2 * cfg.head_dim_ if cfg.use_qk_norm
                                       else 0))


def check_launcher_records(what, records, calls):
    """Every launcher program of a call built per call and captured once,
    at the default byte cap (never eager under the byte rule): its first
    call runs eagerly just before the capture, every later one replays.
    ``calls`` maps program name -> calls. Returns capture seconds and
    held bytes by program."""
    from repro_torch.core import scanloop
    got = {r.name: r for r in records}
    out = {}
    for name, n in calls.items():
        r = got.get(name)
        if r is None or r.cache_key is not None or not r.captured \
                or r.why_uncaptured is not None or r.captures != 1 \
                or r.replays != n - 1 or r.eager_calls:
            fail(f"{what}: program {name} {r} not captured once on its "
                 f"first of {n} calls and replayed on the others at the "
                 f"default byte cap ({scanloop.PROGRAM_CACHE_BYTES} B)")
        out[name] = dict(capture_s=r.capture_seconds,
                         held_bytes=r.held_bytes, replays=r.replays,
                         in_place=r.in_place)
    print(f"{what}: launcher programs captured once each on their first "
          f"call, calls {calls}: {out}", flush=True)
    return out


def host_tree(tree):
    """Every tensor leaf of ``tree`` copied to the host, in order."""
    from torch.utils._pytree import tree_flatten
    return [x.detach().cpu() for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor)]


def same_as_host(host, tree):
    """``tree``'s tensor leaves (on the card) ``==`` ``host`` (their host
    copies, in order), compared on the card one leaf at a time."""
    from torch.utils._pytree import tree_flatten
    leaves = [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]
    return len(host) == len(leaves) and all(
        torch.equal(h.to(x.device), x) for h, x in zip(host, leaves))


def run_serve(cfg, shape=SERVE, twin=False):
    """The serving entry point, counted from 0: each prefill launches B3
    once per recurrent layer and B4 once per attention layer, decode
    neither, and the consensus kernels never; the prefill and decode
    programs are captured once each and replayed (decode once a token).
    A transformer's counted parameters equal ``param_count()`` plus what
    it leaves out. With ``twin`` the same call again under
    ``scanloop.uncaptured()``: tokens, last logits and final caches
    ``==``, the launches by phase the same, its times beside the
    captured ones. Returns the launches and the serving numbers."""
    from repro_torch.core import scanloop
    from repro_torch.launch.serve import serve

    want_prefill = expected_prefill(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    with scanloop.built_programs() as recs:
        res = serve(cfg, seed=0, device=DEVICE, verbose=True, **shape)
    wall = time.perf_counter() - t
    got = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the graph pools' segments count here, not in the allocated peak
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    programs = check_launcher_records(
        f"serve {cfg.name}", recs,
        {"serve_prefill": 1, "serve_decode": shape["gen"] - 1})
    print(f"serve {cfg.name} layers={cfg.num_layers} batch={shape['batch']} "
          f"prompt={shape['prompt_len']} gen={shape['gen']}: prefill_ms="
          f"{res.prefill_ms} decode_ms_per_token={res.decode_ms_per_token} "
          f"(serve's clock: the prefill's one call, eager before its "
          f"capture; the decode steps after the first, replays) "
          f"peak_memory_GB={peak_gb} peak_reserved_GB={reserved_gb} "
          f"wall_s(init included)={wall} launches={got} by phase "
          f"{res.launches}", flush=True)
    if got != want_prefill:
        fail(f"serve {cfg.name} launched {got}, expected {want_prefill}")
    if res.launches["prefill"] != {n: want_prefill[n] for n in
                                   res.launches["prefill"]} \
            or any(res.launches["decode"].values()):
        fail(f"serve {cfg.name} launches by phase {res.launches}")
    if cfg.name in ZOO_COUNTED:
        want_n = ZOO_COUNTED[cfg.name]
        print(f"params counted {res.n_params} == the JAX package's count "
              f"{want_n}: {res.n_params == want_n}; param_count() "
              f"{cfg.param_count()} ({cfg.param_count() - want_n:+d}, the "
              f"reference's formula)", flush=True)
        if res.n_params != want_n:
            fail(f"{cfg.name}: {res.n_params} params, the JAX package "
                 f"counts {want_n}")
    elif cfg.family != "hybrid":
        analytic = cfg.param_count() + uncounted_params(cfg)
        print(f"params counted {res.n_params} = param_count() "
              f"{cfg.param_count()} + {uncounted_params(cfg)} it leaves "
              f"out: {res.n_params == analytic}", flush=True)
        if res.n_params != analytic:
            fail(f"{cfg.name}: {res.n_params} params, analytic {analytic}")
    tok = res.tokens
    if tuple(tok.shape) != (shape["batch"], shape["gen"]) or not bool(
            ((tok >= 0) & (tok < cfg.vocab_size)).all()):
        fail(f"tokens out of range or shape {tuple(tok.shape)}")
    if not torch.isfinite(res.last_logits.float()).all():
        fail(f"{cfg.name}: last-position prefill logits are not finite")
    print(f"tokens[0]={tok[0].tolist()}", flush=True)
    numbers = dict(launches=res.launches, prefill_ms=res.prefill_ms,
                   decode_ms_per_token=res.decode_ms_per_token,
                   peak_memory_GB=peak_gb, peak_reserved_GB=reserved_gb,
                   params=res.n_params, programs=programs)
    if twin:
        mine = [res.tokens.cpu(), res.last_logits.cpu()] + host_tree(
            res.caches)
        del res
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with scanloop.uncaptured():
            eager = serve(cfg, seed=0, device=DEVICE, verbose=False, **shape)
        eager_peak = torch.cuda.max_memory_allocated() / 1e9
        eager_reserved = torch.cuda.max_memory_reserved() / 1e9
        ok = same_as_host(mine, (eager.tokens, eager.last_logits,
                                 eager.caches))
        print(f"serve {cfg.name} captured == uncaptured (tokens, last "
              f"logits, {len(mine) - 2} cache leaves): {ok}; eager "
              f"prefill_ms={eager.prefill_ms} decode_ms_per_token="
              f"{eager.decode_ms_per_token} peak_memory_GB={eager_peak} "
              f"peak_reserved_GB={eager_reserved}; launches by phase "
              f"{eager.launches}", flush=True)
        if not ok or eager.launches != numbers["launches"]:
            fail(f"serve {cfg.name}: the captured programs differ from "
                 "the same call under uncaptured()")
        numbers["eager"] = dict(prefill_ms=eager.prefill_ms,
                                decode_ms_per_token=eager.decode_ms_per_token,
                                peak_memory_GB=eager_peak,
                                peak_reserved_GB=eager_reserved)
        del eager, mine
        torch.cuda.empty_cache()
    return got, numbers


@torch.no_grad()
def profile_serve(cfg, steps=4, shape=SERVE):
    """Where the serving time goes, at full size: host wall, kernels
    launched and device kernel time of one prefill and of ``steps``
    decode steps, from ``torch.profiler`` traces (after a warm prefill).
    B3/B4's share of the prefill's device time is read from the trace; a
    MoE's dispatch share from its layers timed alone
    (:func:`moe_dispatch_share`). Returns the numbers (None when the trace
    holds no device kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import frontend
    from repro_torch.models.api import get_model

    B, S = shape["batch"], shape["prompt_len"]
    api = get_model(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    model = api.cast_for_serving(api.init(cfg, generator=gen, device=DEVICE),
                                 cfg)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEVICE)
    batch = {"tokens": prompts}
    if cfg.family == "encdec":
        batch["frames"] = frontend.audio_frame_embeddings(gen, cfg, B,
                                                          device=DEVICE)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def run_prefill():
        caches = api.init_cache(cfg, B, S + steps + 1, device=DEVICE)
        last, caches = prefill(model, caches, batch)
        torch.cuda.synchronize()
        return torch.argmax(last[:, -1], -1).to(torch.int32)[:, None], caches

    def run_decode(nxt, caches):
        for i in range(steps):
            nxt, caches = decode(model, caches, {"tokens": nxt,
                                                 "cache_index": S + i})
        torch.cuda.synchronize()

    nxt, caches = run_prefill()                       # warm-up
    run_decode(nxt, caches)
    t = time.perf_counter()
    nxt, caches = run_prefill()
    wall_p = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    run_decode(nxt, caches)
    wall_d = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=acts) as prof:
        nxt, caches = run_prefill()
    _, kp = trace_kernels(prof, f"serve_prefill_{cfg.name}")
    with profile(activities=acts) as prof:
        run_decode(nxt, caches)
    _, kd = trace_kernels(prof, f"serve_decode_{cfg.name}")
    if not kp or not kd:
        print("profiler trace holds no device kernels: device time not "
              "measured", flush=True)
        return None
    busy_p = sum(e.get("dur", 0) for e in kp) / 1e3
    b3 = sum(e.get("dur", 0) for e in kp if "rglru_scan_kernel" in e["name"]) / 1e3
    b4 = sum(e.get("dur", 0) for e in kp
             if "flash_attention_kernel" in e["name"]) / 1e3
    busy_d = sum(e.get("dur", 0) for e in kd) / 1e3 / steps
    print(f"{cfg.name} prefill {B}x{S}: wall_ms={wall_p} kernels={len(kp)} "
          f"device_busy_ms={busy_p} busy_share={busy_p / wall_p} "
          f"rglru_scan_ms={b3} ({b3 / busy_p:.4f} of device time) "
          f"flash_attention_ms={b4} ({b4 / busy_p:.4f})", flush=True)
    top_kernels(kp, 1)
    print(f"{cfg.name} decode step (batch {B}): wall_ms={wall_d} "
          f"kernels_per_step={len(kd) / steps} device_busy_ms={busy_d} "
          f"busy_share={busy_d / wall_d}", flush=True)
    top_kernels(kd, steps)
    if cfg.moe is not None:
        moe_dispatch_share(cfg, model.blocks[0].mlp, busy_p, busy_d)
    del caches, nxt
    torch.cuda.empty_cache()
    captured = profile_serving_programs(cfg, model, batch, steps)
    return dict(prefill_wall_ms=wall_p, prefill_kernels=len(kp),
                prefill_busy_ms=busy_p, flash_attention_ms=b4,
                rglru_scan_ms=b3, decode_wall_ms=wall_d,
                decode_kernels_per_step=len(kd) / steps,
                decode_busy_ms=busy_d, decode_busy_share=busy_d / wall_d,
                captured=captured)


@torch.no_grad()
def profile_serving_programs(cfg, model, batch, steps):
    """The same work through ``serve``'s programs (``serving_programs``):
    the prefill program's first call and capture, then one replay timed
    (``serve`` runs the prefill once, eagerly before its capture); the
    prefill program dropped, then the decode program from its caches:
    captured, ``steps`` replays timed and ``steps`` profiled. Host wall,
    kernels and busy share, the capture seconds, the held bytes and the
    peaks, allocated and reserved (the graph pools)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serving_programs
    from repro_torch.models.api import get_model

    B, S = batch["tokens"].shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    prefill, decode = serving_programs(cfg)
    st = {"caches": get_model(cfg).init_cache(cfg, B, S + 2 * steps + 2,
                                              device=DEVICE)}
    positions = torch.arange(S, S + 2 * steps + 1, dtype=torch.int32,
                             device=DEVICE)
    step_no = [0]

    def run_prefill():
        (st["caches"],), (_, st["nxt"]) = prefill(model, st["caches"],
                                                  batch)
        torch.cuda.synchronize()

    def run_decode(n):
        for _ in range(n):
            (st["caches"],), st["nxt"] = decode(
                model, st["caches"], {"tokens": st["nxt"],
                                      "cache_index": positions[step_no[0]]})
            step_no[0] += 1
        torch.cuda.synchronize()

    run_prefill()                                     # its call, captured
    t = time.perf_counter()
    run_prefill()                                     # a replay
    wall_p = (time.perf_counter() - t) * 1e3
    st["nxt"] = st["nxt"].clone()
    out = dict(prefill_capture_s=prefill.record.capture_seconds,
               prefill_replay_wall_ms=wall_p,
               prefill_held_bytes=prefill.record.held_bytes)
    del prefill                                       # as ``serve`` does
    run_decode(1)                                     # its call, captured
    t = time.perf_counter()
    run_decode(steps)
    wall_d = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=acts) as prof:
        run_decode(steps)
    _, kd = trace_kernels(prof, f"serve_decode_captured_{cfg.name}")
    out.update(decode_capture_s=decode.record.capture_seconds,
               decode_replay_wall_ms=wall_d,
               decode_kernels_per_step=len(kd) / steps,
               decode_held_bytes=decode.record.held_bytes,
               peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_GB=torch.cuda.max_memory_reserved() / 1e9,
               # the prefill's pool is gone: the decode's alone beside the
               # model, the caches and the allocator's cached blocks
               decode_reserved_GB=torch.cuda.memory_reserved() / 1e9)
    if kd:
        busy_d = sum(e.get("dur", 0) for e in kd) / 1e3 / steps
        out.update(decode_busy_ms=busy_d, decode_busy_share=busy_d / wall_d)
    print(f"{cfg.name} serving programs (captured; replays timed, host "
          f"clock): {out}", flush=True)
    del st, decode
    torch.cuda.empty_cache()
    return out


def moe_dispatch_share(cfg, p, busy_prefill_ms, busy_decode_ms):
    """One MoE layer at the prefill's and a decode step's token counts,
    timed alone (medians of 20, CUDA events): the whole block, and its
    dispatch (router + top-k + position-in-expert, the scatter into the
    (E, cap, d) buffer, the gather and gate-weighted combine) apart from
    the expert products and the shared expert; then the MoE layers'
    share of the profiled device time."""
    from repro_torch.models import moe

    B, S, d = SERVE["batch"], SERVE["prompt_len"], cfg.d_model
    E, k, L = cfg.moe.num_experts, cfg.moe.top_k, cfg.num_layers
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for label, n, busy in (("prefill", B * S, busy_prefill_ms),
                           ("decode", B, busy_decode_ms)):
        x = torch.randn(n, d, generator=gen, device=DEVICE).to(
            getattr(torch, cfg.dtype))
        r = moe.route(p, cfg, x)
        buf = moe.dispatch(r, x, k, E)
        ho = moe.experts(p, cfg, buf)
        t_route = median_ms(lambda: moe.route(p, cfg, x))
        t_scatter = median_ms(lambda: moe.dispatch(r, x, k, E))
        t_experts = median_ms(lambda: moe.experts(p, cfg, buf))
        t_combine = median_ms(lambda: moe.combine(r, ho, n, k))
        t_block = median_ms(lambda: moe.moe_block(p, cfg, x[None]))
        t_disp = t_route + t_scatter + t_combine
        print(f"{cfg.name} MoE layer, {label} ({n} tokens, cap {r.cap}): "
              f"block_ms={t_block} dispatch_ms={t_disp} (route {t_route}, "
              f"scatter {t_scatter}, combine {t_combine}; "
              f"{t_disp / t_block:.4f} of the block) experts_ms={t_experts} "
              f"({t_experts / t_block:.4f}); {L} layers alone "
              f"{L * t_block} ms against {busy} ms device-busy per "
              f"{label} ({L * t_block / busy:.4f}; dispatch "
              f"{L * t_disp / busy:.4f})", flush=True)


@torch.no_grad()
def check_decode_vs_forward(cfg, layers, batch=2, prompt=2100,
                            rms_gate=False):
    """Full width, ``layers`` layers: prefill + 1 decode step through the
    caches equals the full forward at the last position (a prompt longer
    than the window, so a circular cache wraps), within DECODE_TOL of
    each logit (abs + rel), or with ``rms_gate`` within DECODE_TOL·(1 +
    rms of the forward's logits). B4 runs once per attention layer in the
    prefill, never in the decode step. The weights and inputs depend on
    the seed alone (encdec frames drawn in f32), not on ``cfg.dtype``.
    Returns (decode, forward) logits at the last position, f32."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import frontend
    from repro_torch.models.api import get_model

    cfgl = dataclasses.replace(cfg, num_layers=layers)
    if cfg.encdec is not None:
        cfgl = dataclasses.replace(cfgl, encdec=dataclasses.replace(
            cfg.encdec, num_encoder_layers=layers))
    api = get_model(cfgl)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    model = api.cast_for_serving(
        api.init(cfgl, generator=gen, device=DEVICE), cfgl)
    toks = torch.randint(0, cfgl.vocab_size, (batch, prompt), generator=gen,
                         device=DEVICE)
    enc = {} if cfg.encdec is None else {
        "embeddings": frontend.audio_frame_embeddings(
            gen, dataclasses.replace(cfgl, dtype="float32"), batch,
            device=DEVICE)}
    caches = api.init_cache(cfgl, batch, prompt + 1, device=DEVICE)
    zero_counts()
    last, caches = make_prefill_step(cfgl)(
        model, caches, {"tokens": toks, "frames": enc.get("embeddings")})
    nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    prefill_counts = launch_counts()
    zero_counts()
    step, _, _ = api.forward(model, cfgl, nxt, caches=caches,
                             cache_index=prompt)
    make_decode_step(cfgl)(model, caches, {"tokens": nxt,
                                           "cache_index": prompt})
    decode_counts = launch_counts()
    full, _, _ = api.forward(model, cfgl, torch.cat([toks, nxt], 1),
                             last_only=True, **enc)
    torch.cuda.synchronize()
    a, b = step[:, -1].float(), full[:, -1].float()
    rms = float(b.square().mean().sqrt())
    gate = (DECODE_TOL * (1 + rms) if rms_gate
            else DECODE_TOL + DECODE_TOL * b.abs())
    worst = float(((a - b).abs() / gate).max())
    what = f", {cfgl.dtype}" + ("" if cfgl.moe is None else
                                f", capacity factor {cfgl.moe.capacity_factor}")
    print(f"{cfgl.name} decode vs full forward ({layers} layers, width "
          f"{cfgl.d_model}, batch {batch}, prompt {prompt}{what}): max |d| = "
          f"{float((a - b).abs().max())}, rms of the logits {rms}, "
          f"{worst:.4g} of the {DECODE_TOL} "
          f"{'x (1 + rms)' if rms_gate else 'abs+rel'} gate; launches "
          f"prefill {prefill_counts} decode {decode_counts}", flush=True)
    if not torch.isfinite(a).all() or worst > 1.0:
        fail(f"{cfgl.name}: decode step disagrees with the full forward")
    if any(decode_counts.values()) or prefill_counts != expected_prefill(cfgl):
        fail(f"{cfgl.name} {layers}-layer launches prefill {prefill_counts} "
             f"decode {decode_counts}")
    return a, b


def serve_lm_phase(by_path):
    """The transformer family on the card: (a) h2o-danube-3-4b and
    qwen2-moe-a2.7b served at full width and depth through the entry
    point, each profiled (and the MoE's dispatch timed); (b) decode
    against the full forward for both (qwen2-moe in f32 at capacity
    factor 8.0, so the full forward drops nothing a one-token decode
    keeps); (c) the
    other five archs at full width and two layers, a 1 x 4096 prefill
    each. Returns the serving numbers by arch."""
    from repro_torch.configs import get_arch

    numbers = {}
    for arch in LM_ARCHS:
        t = time.perf_counter()
        cfg = get_arch(arch)
        by_path[f"serve_{arch}"], numbers[arch] = run_serve(cfg, twin=True)
        torch.cuda.empty_cache()
        profile_serve(cfg)
        torch.cuda.empty_cache()
        print(f"(a) {arch}: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    for arch in LM_ARCHS:
        cfg = get_arch(arch)
        if cfg.moe is not None:
            # f32: the JAX init draws each expert stack with fan-in E (std
            # 0.13 at E = 60), so the MoE output is ~10^2 against a
            # residual of ~1 and bf16 rounding alone parts the two paths
            # by about the gate; in f32 they must agree to it
            cfg = dataclasses.replace(cfg, dtype="float32",
                                      moe=dataclasses.replace(
                                          cfg.moe, capacity_factor=8.0))
        check_decode_vs_forward(cfg, LM_DECODE_CHECK["layers"],
                                LM_DECODE_CHECK["batch"],
                                LM_DECODE_CHECK["prompt"])
        torch.cuda.empty_cache()
    print(f"(b) decode vs forward: {time.perf_counter() - t:.2f} s",
          flush=True)
    t = time.perf_counter()
    for arch in TWO_LAYER_ARCHS:
        cfg = dataclasses.replace(get_arch(arch), num_layers=2)
        by_path[f"serve_2l_{arch}"], numbers[f"{arch} (2 layers)"] = \
            run_serve(cfg, dict(batch=1, prompt_len=SERVE["prompt_len"],
                                gen=2))
        torch.cuda.empty_cache()
    print(f"(c) two-layer archs: {time.perf_counter() - t:.2f} s", flush=True)
    return numbers


def _rel_err(got, want):
    """max |got - want| over max |want| (want's largest entry)."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def _fwd_gate(got, want, q, k, v, kw):
    """B4's forward against its plain version: the fraction of its gate
    (bf16: the rounding gate; f32: abs + rel) the worst element uses."""
    from repro_torch.kernels import ref
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        pv = ref.attention_reference(q.float(), k.float(), v.float().abs(),
                                     **kw)
        gate = (B4_BF16_REL * want.float().abs() + B4_BF16_PV * pv
                + B4_BF16_ABS)
    else:
        gate = B4_F32_TOL + B4_F32_TOL * want.float().abs()
    return float((diff / gate).max()), float(diff.max())


def sdpa_backward_ms(q, k, v, g, causal, window):
    """SDPA's backward at these shapes, as forward + backward − forward
    (kv heads repeated to H, the causal / window mask as a boolean mask
    where the window cuts keys; softcap 0: SDPA has none); the library
    yardstick, never called by the port."""
    import torch.nn.functional as F
    H, S, T = q.shape[2], q.shape[1], k.shape[1]
    qt = q.detach().transpose(1, 2).requires_grad_()
    kt, vt = (x.detach().repeat_interleave(H // k.shape[2], 2)
              .transpose(1, 2).requires_grad_() for x in (k, v))
    gt = g.transpose(1, 2)
    kw = dict(is_causal=causal)
    if 0 < window < max(S, T):
        pos_q = torch.arange(S, device=q.device)[:, None]
        pos_k = torch.arange(T, device=q.device)[None, :]
        mask = pos_k > pos_q - window
        if causal:
            mask &= pos_k <= pos_q
        kw = dict(attn_mask=mask)
    fwd = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw))
    both = median_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, **kw), (qt, kt, vt), gt))
    return both - fwd


def b4_backward(generator, label, shape, kw, dtype):
    """B4′ (``ops.flash_attention_backward``) at ``shape`` (B, S, H, K, T,
    hd) against its plain version on the same inputs: each gradient's max
    |d| / max |plain| under GRAD_F32_REL / GRAD_BF16_REL, against autograd
    through the plain forward under GRAD_ROUTE_FACTOR times that, one
    launch a call, two launches the same bits; kernel, plain and SDPA
    backward ms and the bound. Returns the row."""
    from repro_torch.kernels import ops, ref, work
    B, S, H, K, T, hd = shape

    def randn(*s):
        return torch.randn(*s, generator=generator, device=DEVICE).to(dtype)

    q, k, v, g = randn(B, S, H, hd), randn(B, T, K, hd), randn(B, T, K, hd), \
        randn(B, S, H, hd)
    before = ops.flash_attention_backward.launches
    got = ops.flash_attention_backward(q, k, v, g, **kw)
    launched = ops.flash_attention_backward.launches - before
    again = ops.flash_attention_backward(q, k, v, g, **kw)
    want = ref.attention_backward_reference(q, k, v, g, **kw)
    torch.cuda.synchronize()
    err = [_rel_err(a, b) for a, b in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    route = torch.autograd.grad(ref.attention_reference(*ins, **kw), ins, g)
    route_err = [_rel_err(a, b) for a, b in zip(got, route)]
    max_abs = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
    del again, want, ins, route
    rel = GRAD_F32_REL if dtype == torch.float32 else GRAD_BF16_REL
    row = dict(shape=[list(q.shape), list(k.shape)], dtype=str(dtype),
               **kw, grad_rel_err=max(err),
               route_rel_err=max(route_err), max_abs_err=max_abs,
               launches=launched, deterministic=same)
    if max(err) > rel or max(route_err) > GRAD_ROUTE_FACTOR * rel \
            or launched != 1 or not same or not all(
                torch.isfinite(x.float()).all() for x in got):
        fail(f"flash_attention_backward {label} {dtype}: {row}")
    del got
    row["ms"] = median_ms(lambda: ops.flash_attention_backward(
        q, k, v, g, **kw))
    row["plain_ms"] = median_ms(lambda: ref.attention_backward_reference(
        q, k, v, g, **kw))
    row["library_ms"] = sdpa_backward_ms(q, k, v, g, kw["causal"],
                                         kw["window"])
    nbytes, flops = work.flash_attention_backward(
        B, S, T, H, K, hd, causal=kw["causal"], window=kw["window"],
        elem=q.element_size())
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, flops,
        BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    # the gradient's 10·hd flops a visible pair over the kernel's time,
    # and the kernel's time over SDPA's backward
    row["tflops"] = flops / row["ms"] / 1e9
    row["vs_library"] = row["ms"] / row["library_ms"]
    print(f"flash_attention_backward {label} q {tuple(q.shape)} kv "
          f"{tuple(k.shape)} {dtype} {kw}: dq, dk, dv max |d| / max |plain| "
          f"= {err} (gate {rel}), vs autograd through the plain forward "
          f"{route_err} (gate {GRAD_ROUTE_FACTOR * rel}); launches "
          f"{launched}, two launches equal bits: {same}; kernel_ms="
          f"{row['ms']} plain_ms={row['plain_ms']} library_ms(SDPA backward"
          f"{', softcap 0' if kw['softcap'] else ''})={row['library_ms']} "
          f"bound_ms={row['bound_ms']} ({row['bound_by']}); achieved "
          f"{row['tflops']} TFLOP/s of the 10·hd work; kernel / SDPA "
          f"backward {row['vs_library']}", flush=True)
    del q, k, v, g
    torch.cuda.empty_cache()
    return row


def b4_backward_rows(generator, shapes):
    """:func:`b4_backward` at each of ``shapes`` in f32 and bf16."""
    return {f"{label} {str(dt).replace('torch.', '')}": b4_backward(
        generator, label, shape, kw, dt)
        for label, (shape, kw) in shapes.items()
        for dt in (torch.float32, torch.bfloat16)}


def check_lm_gradients(generator):
    """(a) B4 and B3 with their gradients on the card at the training
    shapes, against the plain versions; forward and forward+backward
    times. Returns the rows' training-shape numbers and max errors."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    B, S, H, K, hd = 4, 512, 32, 8, 128
    kw = dict(causal=True, window=0)
    b4, b4_err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, S, n, hd, generator=generator,
                               device=DEVICE).to(dtype).requires_grad_()
                   for n in (H, K, K))
        w = torch.randn(B, S, H, hd, generator=generator, device=DEVICE)
        before = launch_counts()
        out = ops.flash_attention(q, k, v, **kw)
        got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
        after = launch_counts()
        launched = [after[n] - before[n] for n in ("flash_attention",
                                                   "flash_attention_backward")]
        plain = ref.attention_reference(q, k, v, **kw)
        want = torch.autograd.grad((plain.float() * w).sum(), (q, k, v))
        with torch.no_grad():
            worst, err = _fwd_gate(out, plain, q, k, v, kw)
        # the backward is B4′; autograd through the plain forward is
        # another route to the same gradient (b4_backward)
        rel = GRAD_ROUTE_FACTOR * (GRAD_F32_REL if dtype == torch.float32
                                   else GRAD_BF16_REL)
        gerr = [_rel_err(a, b) for a, b in zip(got, want)]
        b4_err = max(b4_err, err)
        print(f"flash_attention grad {tuple(q.shape)} kv {tuple(k.shape)} "
              f"{dtype}: forward {worst:.4g} of its gate (max |d| {err}); "
              f"dq, dk, dv (B4′) max |d| / max |autograd through plain| = "
              f"{gerr} (gate {rel}); launches B4, B4′ {launched}",
              flush=True)
        if worst > 1.0 or max(gerr) > rel or launched != [1, 1] or not all(
                torch.isfinite(x).all() for x in got):
            fail(f"flash_attention gradient {dtype}: {gerr}, forward "
                 f"{worst}, launches {launched}")
        del out, plain, got, want
        g = w.to(dtype)
        grads = (q, k, v)
        t = dict(
            fwd_ms=median_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            fwd_bwd_ms=median_ms(lambda: torch.autograd.grad(
                ops.flash_attention(q, k, v, **kw), grads, g)),
            plain_fwd_ms=median_ms(lambda: ref.attention_reference(
                q, k, v, **kw)),
            plain_fwd_bwd_ms=median_ms(lambda: torch.autograd.grad(
                ref.attention_reference(q, k, v, **kw), grads, g)))
        # library yardstick: SDPA's causal attention with the kv heads
        # repeated outside the timed calls; never called by the port
        qt = q.detach().transpose(1, 2).requires_grad_()
        kt, vt = (x.detach().repeat_interleave(H // K, 2).transpose(1, 2)
                  .requires_grad_() for x in (k, v))
        gt = g.transpose(1, 2)
        t["sdpa_fwd_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        t["sdpa_fwd_bwd_ms"] = median_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            (qt, kt, vt), gt))
        t["bwd_ms"] = t["fwd_bwd_ms"] - t["fwd_ms"]
        pairs = visible_pairs(S, S, True, 0)
        t["bound_ms"], t["bound_by"] = bound(
            *b4_work(q, k, True, 0, (
                q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
                4 * hd * pairs * B * H)),
            BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
        t["grad_rel_err"] = max(gerr)
        print(f"flash_attention {dtype} at the training shape: {t}",
              flush=True)
        b4[str(dtype).replace("torch.", "")] = t
        del q, k, v, w, g, qt, kt, vt, gt

    # vmap(grad) over 3 batches of q: ONE launch, the loop's gradients
    qs = torch.randn(3, B, S, H, hd, generator=generator, device=DEVICE)
    k, v = (torch.randn(B, S, K, hd, generator=generator, device=DEVICE)
            for _ in range(2))

    def loss(attn):
        return lambda q, k, v: attn(q, k, v, **kw).square().sum()

    before = launch_counts()
    got = torch.func.vmap(torch.func.grad(loss(ops.flash_attention),
                                          argnums=(0, 1, 2)),
                          in_dims=(0, None, None))(qs, k, v)
    after = launch_counts()
    launched, launched_bwd = (after[n] - before[n] for n in (
        "flash_attention", "flash_attention_backward"))
    verr = 0.0
    for i in range(3):
        want = torch.func.grad(loss(ref.attention_reference),
                               argnums=(0, 1, 2))(qs[i], k, v)
        verr = max([verr] + [_rel_err(got[j][i], want[j]) for j in range(3)])
    print(f"flash_attention vmap(grad) over 3 x {tuple(qs.shape[1:])} f32: "
          f"launches B4 {launched}, B4′ {launched_bwd}, max |d| / max "
          f"|loop through plain| = {verr} (gate {GRAD_F32_REL})", flush=True)
    if launched != 1 or launched_bwd != 1 or verr > GRAD_F32_REL:
        fail(f"flash_attention vmap(grad): launches {launched} / "
             f"{launched_bwd}, err {verr}")
    del qs, k, v, got

    # B4′ at every training shape; B3 and B3′ at (2, 256, 512) with h0
    b4p = b4_backward_rows(generator, B4_BWD_SHAPES)
    b3, b3p = b3_gradient(generator, 2, 256, 512, with_h0=True)
    return {"flash_attention": b4, "rglru_scan": b3,
            "flash_attention_backward": b4p, "rglru_scan_backward": b3p,
            "rglru_scan_backward_extra": b3_backward_extra(generator)}, \
        b4_err


def kernel_device_ms(fn, name, label, n=10, evict=None):
    """Device ms a call of the kernels whose names hold ``name``, alone:
    their sum in a ``torch.profiler`` trace of ``n`` calls (written to
    ``build/profile/<label>.json``), over ``n`` (CUDA events also hold the
    wrapper's host work where the card waits for it); with ``evict`` (a
    tensor larger than the 50 MB L2) read before each call, so the inputs
    come from device memory and no dirty line is left to write back.
    A trace that holds other than ``n`` such kernels is taken again (the
    profiler was seen to return traces without device events); fails if
    three in a row do."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if evict is not None:
                    evict.sum()   # read: the L2 left clean
                fn()
            torch.cuda.synchronize()
        _, kernels = trace_kernels(prof, label)
        hits = [e.get("dur", 0) for e in kernels
                if name in e.get("name", "")]
        if len(hits) == n:
            return sum(hits) / n / 1e3
        print(f"{label}: {len(hits)} {name} kernels in the trace of {n} "
              "calls; tracing again", flush=True)
    fail(f"{label}: no complete trace of {n} {name} calls in three")


def b3_backward(generator, B, T, W, *, with_h0, dtype, timed=True):
    """B3′ (``ops.rglru_scan_backward``) at (B, T, W) in ``dtype``, with
    g_last, against its plain version on the same inputs: ``==`` (the
    same rounded steps in the same order), one launch a call; then, if
    ``timed``, kernel and plain ms, the kernel's device time alone (the
    profiler's) warm and with the L2 evicted before each call, and the
    byte bound (no library call computes the scan). Returns the row."""
    from repro_torch.kernels import ops, ref, work

    def randn(*s):
        return torch.randn(*s, generator=generator, device=DEVICE)

    log_a = (-torch.rand(B, T, W, generator=generator, device=DEVICE)
             * 0.5).to(dtype)
    b, g = randn(B, T, W).to(dtype), randn(B, T, W).to(dtype)
    h0, g_last = (randn(B, W) if with_h0 else None), randn(B, W)
    h, _ = ops.rglru_scan(log_a, b, h0)
    before = ops.rglru_scan_backward.launches
    got = ops.rglru_scan_backward(log_a, b, h0, h, g, g_last)
    launched = ops.rglru_scan_backward.launches - before
    want = ref.rglru_scan_backward_reference(log_a, b, h0, h, g, g_last)
    torch.cuda.synchronize()
    pairs = [(x, y) for x, y in zip(got, want) if x is not None]
    equal = all(torch.equal(x, y) for x, y in pairs)
    row = dict(shape=[B, T, W], dtype=str(dtype), with_h0=with_h0,
               equal=equal, launches=launched, max_abs_err=max(
                   float((x.float() - y.float()).abs().max())
                   for x, y in pairs))
    if not equal or launched != 1:
        fail(f"rglru_scan_backward ({B}, {T}, {W}) {dtype}: {row}")
    del got, want
    what = f"rglru_scan_backward ({B}, {T}, {W}) {dtype}" + (
        " with h0" if with_h0 else "")
    if not timed:
        print(f"{what}: == plain {equal}, launches {launched}", flush=True)
        return row

    def call():
        return ops.rglru_scan_backward(log_a, b, h0, h, g, g_last)

    row["ms"] = median_ms(call)
    label = f"b3_backward_{B}x{T}x{W}_{str(dtype).replace('torch.', '')}"
    row["device_ms"] = kernel_device_ms(call, "rglru_scan_bwd_kernel",
                                        label + "_warm")
    evict = torch.zeros(32 << 20, device=DEVICE)   # 128 MB
    row["device_ms_l2_evicted"] = kernel_device_ms(
        call, "rglru_scan_bwd_kernel", label + "_evicted", evict=evict)
    del evict
    row["plain_ms"] = median_ms(lambda: ref.rglru_scan_backward_reference(
        log_a, b, h0, h, g, g_last), iters=5, warmup=1)
    row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = bound(*work.rglru_scan_backward(
        B, T, W, with_h0=with_h0, with_g_last=True, elem=log_a.element_size()))
    print(f"{what}: == plain {equal}, launches {launched}; kernel_ms="
          f"{row['ms']} device_ms={row['device_ms']} (L2 evicted "
          f"{row['device_ms_l2_evicted']}) plain_ms={row['plain_ms']} "
          f"bound_ms={row['bound_ms']} ({row['bound_by']})", flush=True)
    return row


#: B3′ beyond the training shapes (its 64-step chunks, clusters of 8):
#: T and W ragged over two laps and a third (W odd: each thread loads its
#: own column, no TMA), and exactly two laps at the hybrid's width
B3P_EXTRA_SHAPES = ((3, 1101, 515, True), (2, 1024, 4096, False))


def b3_backward_extra(generator):
    """B3′ ``==`` its plain version, one launch a call, at
    B3P_EXTRA_SHAPES in f32 and bf16 (untimed). Returns the rows."""
    return {f"({B}, {T}, {W}) {str(dt).replace('torch.', '')}": b3_backward(
        generator, B, T, W, with_h0=with_h0, dtype=dt, timed=False)
        for B, T, W, with_h0 in B3P_EXTRA_SHAPES
        for dt in (torch.float32, torch.bfloat16)}


def b3_gradient(generator, B, T, W, *, with_h0):
    """B3 with its gradient at (B, T, W) f32 (from an h0, or from zero as a
    training forward runs it) against autograd through the plain version:
    each gradient's max |d| / max |plain| under GRAD_F32_REL, the forward
    under B3_TOL, one launch of B3 and one of B3′; forward and
    forward+backward times of both, and the forward's byte bound. Then
    B3′ alone in f32 and bf16 (:func:`b3_backward`). Returns the numbers
    and B3′'s rows."""
    from repro_torch.kernels import ops, ref, work

    log_a = (-torch.rand(B, T, W, generator=generator, device=DEVICE)
             * 0.5).requires_grad_()
    b = torch.randn(B, T, W, generator=generator, device=DEVICE
                    ).requires_grad_()
    h0 = (torch.randn(B, W, generator=generator, device=DEVICE
                      ).requires_grad_() if with_h0 else None)
    ins = tuple(x for x in (log_a, b, h0) if x is not None)
    before = launch_counts()
    h, last = ops.rglru_scan(log_a, b, h0)
    got = torch.autograd.grad(h.square().sum() + last.sum(), ins)
    after = launch_counts()
    launched = [after[n] - before[n] for n in ("rglru_scan",
                                               "rglru_scan_backward")]
    wh, wl = ref.rglru_scan_reference(log_a, b, h0)
    want = torch.autograd.grad(wh.square().sum() + wl.sum(), ins)
    err = [_rel_err(x, y) for x, y in zip(got, want)]
    fwd = float(((h - wh).detach().abs() / wh.detach().abs().clamp(min=1)).max())
    what = f"({B}, {T}, {W}) f32" + (" with h0" if with_h0 else "")
    print(f"rglru_scan grad {what}: max |d| / max |plain| = {err} (gate "
          f"{GRAD_F32_REL}); forward max |d| / max(1, |plain|) = {fwd} "
          f"(gate {B3_TOL}); launches B3, B3′ {launched}", flush=True)
    if max(err) > GRAD_F32_REL or fwd > B3_TOL or launched != [1, 1] \
            or not all(torch.isfinite(x).all() for x in got):
        fail(f"rglru_scan gradient {what}: {err}, forward {fwd}, launches "
             f"{launched}")
    cot = (torch.ones_like(h), torch.ones_like(last))
    n = B * T * W
    numbers = dict(
        fwd_ms=median_ms(lambda: ops.rglru_scan(log_a, b, h0)),
        fwd_bwd_ms=median_ms(lambda: torch.autograd.grad(
            ops.rglru_scan(log_a, b, h0), ins, cot)),
        plain_fwd_ms=median_ms(lambda: ref.rglru_scan_reference(
            log_a, b, h0)),
        plain_fwd_bwd_ms=median_ms(lambda: torch.autograd.grad(
            ref.rglru_scan_reference(log_a, b, h0), ins, cot)),
        grad_rel_err=max(err), max_abs_err=float((h - wh).detach().abs().max()))
    numbers["bwd_ms"] = numbers["fwd_bwd_ms"] - numbers["fwd_ms"]
    # the forward's bytes as in ``lm_kernels``: log_a and b read, h
    # written, h0 and h_last rows; exp + mul + add per element
    numbers["bound_ms"], numbers["bound_by"] = bound(*same_work(
        "rglru_scan", work.rglru_scan(B, T, W, with_h0=with_h0),
        (12 * n + (8 if with_h0 else 4) * B * W, 3 * n)))
    print(f"rglru_scan {what}: {numbers}", flush=True)
    del log_a, b, h0, h, last, got, want, wh, wl, ins, cot
    bwd = {str(dt).replace("torch.", ""): b3_backward(
        generator, B, T, W, with_h0=with_h0, dtype=dt)
        for dt in (torch.float32, torch.bfloat16)}
    return numbers, bwd


def check_step1(name, got, want):
    """Step 1's (loss, grad norm) with the kernels against the same step
    with their plain versions, under TRAIN_LOSS_REL / TRAIN_GNORM_REL."""
    (l0, g0), (l1, g1) = got, want
    dl, dg = abs(l0 - l1) / abs(l1), abs(g0 - g1) / abs(g1)
    print(f"{name} step 1 with the kernels vs their plain versions: loss "
          f"{l0} vs {l1} (rel {dl}, gate {TRAIN_LOSS_REL}), grad norm {g0} "
          f"vs {g1} (rel {dg}, gate {TRAIN_GNORM_REL})", flush=True)
    if not dl <= TRAIN_LOSS_REL or not dg <= TRAIN_GNORM_REL:
        fail(f"{name} train_standard step 1: loss rel {dl}, grad norm rel "
             f"{dg}")
    return dict(loss_rel=dl, grad_norm_rel=dg)


def train_cfg():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_LAYERS)


class plain_kernels:
    """Within the block, the models call B4's and B3's plain versions
    (autograd through them) instead of the kernels: the reference runs of
    ``train_lm`` (b) and ``zoo`` (d), (f)."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ops = ops
        self.real = (ops.flash_attention, ops.rglru_scan)

        def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
            return ref.attention_reference(q, k, v, causal=causal,
                                           window=window, softcap=softcap)

        def scan(log_a, b, h0=None):
            return ref.rglru_scan_reference(log_a, b, h0)
        attention.launches = scan.launches = 0
        ops.flash_attention, ops.rglru_scan = attention, scan

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.rglru_scan = self.real


#: B4′'s device ms in each profiled training step while its bf16 path
#: ran on CUDA cores in f32 (PERF.md §6, the SIMT kernel's last call),
#: printed beside this run's: the first key found in the profile's name
B4P_SIMT_DEVICE_MS = {
    "whisper-large-v3": 207.9,
    "recurrentgemma-9b": 1.31,
    "granite-8b": 3.41,
    "train_federated_round": 5.14,
    "train_standard_step": 3.41,      # granite-8b's eager step
}


def profile_step(fn, name, n=1):
    """Device kernels and busy share of ``n`` calls of ``fn`` (warm),
    from a ``torch.profiler`` trace; host wall of the same calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) / n * 1e3
    out, kernels = trace_kernels(prof, name)
    busy_ms = sum(e.get("dur", 0) for e in kernels) / n / 1e3
    names = {"B1": lambda s: "quant_consensus_pop_kernel" in s,
             "B2": lambda s: ("consensus_pop_kernel" in s
                              and "quant" not in s),
             "B3": lambda s: "rglru_scan_kernel" in s,
             "B4": lambda s: "flash_attention_kernel" in s,
             "B3′": lambda s: "rglru_scan_bwd_kernel" in s,
             "B4′": lambda s: "flash_attention_bwd_" in s}
    by = {label: sum(e.get("dur", 0) for e in kernels
                     if hit(e.get("name", ""))) / n / 1e3
          for label, hit in names.items()}
    print(f"{name}: wall_ms(profiled)={wall_ms} kernels={len(kernels) / n} "
          f"device_busy_ms={busy_ms} busy_share={busy_ms / wall_ms} "
          f"device_ms_by_kernel={by} (trace {out})", flush=True)
    simt = next((v for k, v in B4P_SIMT_DEVICE_MS.items() if k in name),
                None)
    if simt is not None:
        print(f"{name}: B4′ device ms {by['B4′']} (bf16 on the tensor "
              f"cores) beside {simt} (bf16 on CUDA cores, PERF.md)",
              flush=True)
    if kernels:
        top_kernels(kernels, n)
    return dict(kernels=len(kernels) / n, busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms, device_ms=by)


def plain_step1(cfg, shape):
    """(loss, grad norm) of ``train_standard``'s step 1 with the kernels'
    plain versions: the same seed, so the same params and batch. A
    reference, run eagerly (one step: a capture would only add its
    warm-up)."""
    from repro_torch.core import scanloop
    from repro_torch.launch import train
    out = []
    with plain_kernels(), scanloop.uncaptured():
        train.train_standard(
            cfg, device=DEVICE, **dict(shape, steps=1),
            callback=lambda t, p, m: out.append(
                (float(m["loss"]), float(m["grad_norm"]))))
    return out[0]


def standard_twin(cfg, shape, mine):
    """``train_standard`` at ``shape`` again under ``scanloop.
    uncaptured()``, against the captured run's ``mine`` (host copies of
    the params, Adam's state, the losses and grad norms): ``==`` or fail.
    Returns the eager run's ms a step (steps 2..), its peak and its params
    and state (on the card)."""
    from repro_torch.core import scanloop
    from repro_torch.launch import train

    marks, gnorms = [], []

    def on_step(t, params, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        gnorms.append(float(m["grad_norm"]))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with scanloop.uncaptured():
        params, hist, ost = train.train_standard(
            cfg, device=DEVICE, callback=on_step, return_state=True, **shape)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ok = same_as_host(mine["tree"], (params, ost)) and (
        hist, gnorms) == (mine["hist"], mine["gnorms"])
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    print(f"train_standard {cfg.name} captured == uncaptured (params, Adam "
          f"state, losses, grad norms over {len(hist)} steps): {ok}; eager "
          f"ms per step {step_ms}, median {statistics.median(step_ms)}; "
          f"eager peak_memory_GB={peak} peak_reserved_GB="
          f"{torch.cuda.max_memory_reserved() / 1e9}", flush=True)
    if not ok:
        fail(f"train_standard {cfg.name}: the captured step differs from "
             "the same steps under uncaptured()")
    return dict(ms_per_step=statistics.median(step_ms), step_ms=step_ms,
                peak_memory_GB=peak), params, ost


def profile_step_program(cfg, shape, params, ost, batch):
    """``train_standard``'s step program on ``params`` and ``ost``
    (donated): captured, then one replay profiled. Its numbers, with the
    capture seconds and held bytes."""
    from repro_torch.launch import train
    prog = train.train_step_program(cfg, lr=shape["lr"])
    st = {"p": params, "o": ost}

    def one_step():
        (st["p"], st["o"]), _ = prog(st["p"], st["o"], batch)

    one_step()                                        # capture
    out = profile_step(one_step, f"train_step_captured_{cfg.name}")
    out.update(capture_s=prog.record.capture_seconds,
               held_bytes=prog.record.held_bytes)
    del st, prog
    torch.cuda.empty_cache()
    return out


def run_train_standard():
    """(b) ``train_standard`` at full width, 2 layers, counted from 0:
    its step program captured once and replayed, then the same run under
    ``uncaptured()`` ``==``; each step profiled, eager and captured."""
    from repro_torch.core import scanloop
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step

    cfg = train_cfg()
    L = cfg.num_layers
    per_step = 2 * L if cfg.remat else L
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks, metrics, counts = [], [], []

    def on_step(t, params, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        counts.append(launch_counts()["flash_attention"])

    zero_counts()
    t0 = time.perf_counter()
    with scanloop.built_programs() as recs:
        params, hist, ost = train.train_standard(
            cfg, device=DEVICE, callback=on_step, return_state=True,
            **TRAIN_STD)
    wall = time.perf_counter() - t0
    got = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    programs = check_launcher_records(f"train_standard {cfg.name}", recs,
                                      {"train_step": TRAIN_STD["steps"]})
    steps_b4 = [b - a for a, b in zip([0] + counts, counts)]
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    print(f"train_standard {cfg.name} width {cfg.d_model} layers {L} "
          f"batch {TRAIN_STD['batch']} x {TRAIN_STD['seq']}: losses {hist}, "
          f"grad norms {[g for _, g in metrics]}; ms per step (steps 2-5) "
          f"{step_ms}, median {statistics.median(step_ms)}; peak_memory_GB="
          f"{peak_gb} peak_reserved_GB="
          f"{torch.cuda.max_memory_reserved() / 1e9}; B4 launches per step "
          f"{steps_b4} (remat={cfg.remat}: "
          f"{per_step} = {'2' if cfg.remat else '1'} x {L} layers; B4' "
          f"{L} = one backward a layer); wall_s "
          f"(init included) {wall}; launches {got}", flush=True)
    if not all(np.isfinite(hist)) or steps_b4 != [per_step] * len(hist) \
            or got != dict({n: 0 for n in KERNELS},
                           flash_attention=per_step * len(hist),
                           flash_attention_backward=L * len(hist)):
        fail(f"train_standard: losses {hist}, launches {steps_b4} / {got}")

    mine = dict(tree=host_tree((params, ost)), hist=hist,
                gnorms=[g for _, g in metrics])
    del params, ost
    eager, params, ost = standard_twin(cfg, TRAIN_STD, mine)
    del mine

    step, opt = make_train_step(cfg, lr=TRAIN_STD["lr"], clip_norm=1.0)
    state = {"p": params, "o": ost}
    del params, ost
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_STD["batch"],
                                             TRAIN_STD["seq"] + 1),
                         generator=gen, device=DEVICE)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def one_step():
        state["p"], state["o"], _ = step(state["p"], state["o"], batch)

    one_step()
    prof = profile_step(one_step, "train_standard_step")
    prof_captured = profile_step_program(cfg, TRAIN_STD, state.pop("p"),
                                         state.pop("o"), batch)
    del state
    torch.cuda.empty_cache()

    check_step1(cfg.name, metrics[0], plain_step1(cfg, TRAIN_STD))
    torch.cuda.empty_cache()
    return got, dict(ms_per_step=statistics.median(step_ms),
                     step_ms=step_ms, peak_memory_GB=peak_gb, losses=hist,
                     b4_per_step=per_step, profile=prof, programs=programs,
                     eager=eager, profile_captured=prof_captured)


def fed_run(cfg, **kw):
    """One ``train_federated`` run at the phase's shape on the sparse
    plan, counted from 0: (params, losses, E, codec state), launches,
    wall seconds (init included) and peak memory."""
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    out = train.train_federated(cfg, consensus_plan="sparse", device=DEVICE,
                                return_state=True, **dict(TRAIN_FED, **kw))
    torch.cuda.synchronize()
    return (out, launch_counts(), time.perf_counter() - t,
            torch.cuda.max_memory_allocated() / 1e9)


def fed_expected(cfg, kernel, rounds=None):
    """B4 once per layer of every local step's forward and its remat
    recompute, and of the logged loss; B4′ once per layer of every local
    step's backward; ``kernel`` (B1 or B2) once per leaf per round; over
    TRAIN_FED's rounds, or ``rounds``."""
    R, A, S, L = (rounds or TRAIN_FED["rounds"], TRAIN_FED["agents"],
                  TRAIN_FED["local_steps"], cfg.num_layers)
    want = {n: 0 for n in KERNELS}
    want["flash_attention"] = R * (A * S * (2 if cfg.remat else 1) * L + L)
    want["flash_attention_backward"] = R * A * S * L
    want[kernel] = R * 12                   # the JAX tree's 12 leaves
    return want


def fl_estimate(cfg, codec, consensus_dtype=None):
    """The Eq.-(11) estimate from the host formula: tasks × Eq. (10) of
    one 2-agent cluster, b(W) = 32 bits a param under a codec, else the
    storage (or consensus) bytes."""
    from repro_torch.core import energy, topology
    n = cfg.param_count()
    per = TRAIN_FED["agents"] // TRAIN_FED["tasks"]
    bits = (32.0 * n if codec is not None else
            8.0 * n * (2 if consensus_dtype is not None else 4))
    ep = dataclasses.replace(energy.paper_calibrated("fig3"), model_bits=bits,
                             devices_per_cluster=per,
                             B_i=TRAIN_FED["local_steps"])
    return TRAIN_FED["tasks"] * energy.fl_energy(
        ep, TRAIN_FED["rounds"], topology=topology.clusters(1, per),
        codec=codec)


def to_host(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def same_bits(tree, host):
    return all(torch.equal(v.detach().cpu(), host[k]) for k, v in tree.items())


def run_train_federated(by_path):
    """(c) ``train_federated`` at full width: launches, chunk and
    telemetry bit parity, the host replay, the Eq.-(11) estimate; then
    (d) the checkpoint round trip of the population. Returns numbers."""
    from repro_torch import comms, telemetry
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import energy, topology
    from repro_torch.kernels import build
    from repro_torch.rl.casestudy import delivered_comm_joules

    cfg = train_cfg()
    per = TRAIN_FED["agents"] // TRAIN_FED["tasks"]
    auto = comms.select_codec(topology.clusters(TRAIN_FED["tasks"], per),
                              energy.paper_calibrated("fig3"))
    print(f"codec='auto' at clusters({TRAIN_FED['tasks']}, {per}), "
          f"paper_calibrated('fig3'): {auto.name}", flush=True)
    numbers = {"auto_codec": auto.name}
    b2, b1 = "consensus_update_pop", "quant_consensus_pop"
    host = {}
    for label, kw, kernel in (
            ("none", {}, b2),
            ("bf16_consensus", {"consensus_dtype": torch.bfloat16}, b2),
            ("int8", {"codec": "int8"}, b1),
            ("int8_chunk3", {"codec": "int8", "chunk": 3}, b1),
            ("auto", {"codec": "auto"}, b2)):
        (p, hist, E, st), got, wall, peak = fed_run(cfg, **kw)
        want = fed_expected(cfg, kernel)
        codec = (None if "codec" not in kw else auto if kw["codec"] == "auto"
                 else comms.resolve_codec(kw["codec"]))
        E_host = fl_estimate(cfg, codec, kw.get("consensus_dtype"))
        print(f"train_federated {label}: losses {hist}, E {E} J (host "
              f"formula {E_host}: {E == E_host}), launches {got} (expected "
              f"{want}), wall_s {wall}, peak_memory_GB {peak}", flush=True)
        if got != want or E != E_host or not all(np.isfinite(hist)):
            fail(f"train_federated {label}: launches {got}, E {E} vs "
                 f"{E_host}, losses {hist}")
        by_path[f"train_federated_{label}"] = got
        numbers[label] = dict(losses=hist, E=E, wall_s=wall,
                              peak_memory_GB=peak)
        if label == "int8":
            host = dict(p=to_host(p), st=to_host(st), hist=hist)
        elif label == "int8_chunk3":
            ok = (hist == host["hist"] and same_bits(p, host["p"])
                  and same_bits(st, host["st"]))
            print(f"chunk 3 == chunk 1 (params, losses, error feedback): "
                  f"{ok}", flush=True)
            if not ok:
                fail("train_federated: chunk 3 differs from chunk 1")
            del host
            # (d) the population through a checkpoint, bit for bit
            ckpt = build.BUILD_ROOT.parent / "checkpoint"
            t = time.perf_counter()
            cm = CheckpointManager(str(ckpt), max_to_keep=1)
            cm.save(TRAIN_FED["rounds"], {"params": p},
                    metadata={"arch": cfg.name, "losses": hist})
            t_save = time.perf_counter() - t
            restored, step = cm.restore({"params": p})
            ok = step == TRAIN_FED["rounds"] and all(
                torch.equal(restored["params"][k], p[k]) for k in p)
            nbytes = sum(v.numel() * v.element_size() for v in p.values())
            print(f"(d) checkpoint of the population ({len(p)} leaves, "
                  f"{nbytes / 1e9} GB) saved in {t_save} s, restored in "
                  f"{time.perf_counter() - t - t_save} s: bit for bit "
                  f"{ok}", flush=True)
            shutil.rmtree(ckpt, ignore_errors=True)
            if not ok:
                fail("checkpoint round trip of the population differs")
            del restored
        del p, st
        torch.cuda.empty_cache()

    # links fading and agents sleeping: telemetry off vs buffered
    dyn = dict(codec="int8", dropout_p=0.3, dropout_seed=1, tau=2,
               availability=topology.AgentProcess.bernoulli(0.7, seed=2))
    (p, hist, E, st), got, wall, peak = fed_run(cfg, **dyn)
    by_path["train_federated_async_int8"] = got
    off = dict(p=to_host(p), st=to_host(st), hist=hist)
    del p, st
    tel = telemetry.Telemetry()
    (p, hist_t, _, st), got_t, wall_t, _ = fed_run(cfg, telemetry=tel, **dyn)
    ok = (hist_t == off["hist"] and same_bits(p, off["p"])
          and same_bits(st, off["st"]) and got_t == got)
    del off, p, st
    torch.cuda.empty_cache()
    topo = topology.clusters(TRAIN_FED["tasks"], per)
    R, A = TRAIN_FED["rounds"], TRAIN_FED["agents"]
    keeps = topology.dropout(topo, 0.3, seed=1, rounds=R)
    acts = topology.availability_stream(dyn["availability"], A, R)
    ep = dataclasses.replace(energy.paper_calibrated("fig3"),
                             model_bits=32.0 * cfg.param_count(),
                             devices_per_cluster=per,
                             B_i=TRAIN_FED["local_steps"])
    codec = comms.resolve_codec("int8")
    replay = [delivered_comm_joules(
        topo, [np.asarray(k.adjacency) & a[:, None] & a[None, :]], ep, codec)
        for k, a in zip(keeps, acts)]
    rows = [e["joules"] for e in tel.events(driver="fl")]
    print(f"async int8 (links p 0.3, awake p 0.7, tau 2): losses {hist}; "
          f"buffered telemetry == off (params, losses, error feedback, "
          f"launches): {ok}; row joules {rows} == host replay {replay}: "
          f"{rows == replay}; awake per round {acts.sum(axis=1).tolist()}; "
          f"launches {got}; wall_s off / buffered {wall} / {wall_t}",
          flush=True)
    if not ok or rows != replay:
        fail("train_federated async: telemetry changed the run or a row's "
             "joules differ from the host replay")
    numbers["async_int8"] = dict(losses=hist, wall_s=wall, peak_memory_GB=peak,
                                 row_joules=rows)
    return numbers


def measure_fl_round(codec):
    """ms per federated round of ``train_federated``'s round program
    (``federated_round_program``) at the phase's shape on the sparse
    plan, with the logged loss: under ``uncaptured()`` (eager), then
    captured; each warm, the median of 3 host-clock walls, then one
    profiled round. With a codec, first one round of ``fl_round`` with
    agents 1 and 3 asleep holds their params and residuals bit for bit."""
    from repro_torch.core import scanloop, topology
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.data import TaskTokenDistribution
    from repro_torch.launch import train
    from repro_torch.models.api import lm_loss

    cfg = train_cfg()
    A, T, S = (TRAIN_FED["agents"], TRAIN_FED["tasks"],
               TRAIN_FED["local_steps"])
    topo = topology.clusters(T, A // T)
    engine = ConsensusEngine(topo, codec=codec, plan="sparse")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    params = train.init_params(cfg, gen, DEVICE)
    # one row per agent: the program adopts the population as its buffers
    st = {"p": {k: v.expand((A,) + v.shape).clone()
                for k, v in params.items()}}
    del params
    st["s"] = engine.init_state(st["p"])
    dist = TaskTokenDistribution(vocab_size=cfg.vocab_size, num_tasks=T)
    grid = (torch.arange(A, device=DEVICE) // (A // T))[:, None].expand(A, S)

    def loss_fn(p, tokens, labels):
        return lm_loss(p, cfg, tokens, labels)

    name = "none" if codec is None else codec
    if codec is not None:
        eng = ConsensusEngine(topo, codec=codec, plan="sparse",
                              agents=topology.AgentProcess.bernoulli(0.5))
        act = torch.tensor([True, False, True, False], device=DEVICE)
        ar = eng.async_round(0, eng.init_async_state(device=DEVICE).age,
                             act=act)
        asleep = {k: v[1::2].cpu() for k, v in st["p"].items()}
        asleep_s = {k: v[1::2].cpu() for k, v in st["s"].items()}
        before = {k: v[0].cpu() for k, v in st["p"].items()}
        toks, labels = dist.sample_traced(gen, grid, TRAIN_FED["batch"],
                                          TRAIN_FED["seq"])
        st["p"], st["s"] = train.fl_round(
            eng, loss_fn, st["p"], st["s"], gen, toks, labels,
            lr=TRAIN_FED["lr"], survival=ar.weights, act=ar.act)
        held = all(torch.equal(v[1::2].cpu(), asleep[k])
                   for k, v in st["p"].items()) and all(
            torch.equal(v[1::2].cpu(), asleep_s[k])
            for k, v in st["s"].items())
        moved = not all(torch.equal(v[0].cpu(), before[k])
                        for k, v in st["p"].items())
        print(f"agents 1 and 3 asleep for a round: params and residuals "
              f"held bit for bit {held}; agent 0 moved {moved}", flush=True)
        if not held or not moved:
            fail("train_federated: a sleeping agent's state changed")
        del toks, labels
    prog = train.federated_round_program(
        engine, loss_fn, dist, grid, batch=TRAIN_FED["batch"],
        seq=TRAIN_FED["seq"], lr=TRAIN_FED["lr"])
    st["c"] = (st.pop("p"), st.pop("s"), None, None)
    ts = torch.arange(0, 1, device=DEVICE)
    xs = {"t": ts[0], "link": None, "act": None}

    def one():
        (st["c"],), _ = prog(st["c"], xs, gen)

    def timed(label):
        torch.cuda.reset_peak_memory_stats()
        one()                     # warm; captured: its call and capture
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        return dict(ms_per_round=statistics.median(walls), walls_ms=walls,
                    profile=profile_step(one, label),
                    peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
                    peak_reserved_GB=torch.cuda.max_memory_reserved() / 1e9)

    with scanloop.uncaptured():
        out = timed(f"train_federated_round_{name}")
    print(f"federated round ({name}, sparse, {A} agents x {S} local steps, "
          f"batch {TRAIN_FED['batch']} x {TRAIN_FED['seq']}) through "
          f"train_federated's program under uncaptured(): {out}", flush=True)
    out["captured"] = timed(f"train_federated_round_captured_{name}")
    out["captured"].update(capture_s=prog.record.capture_seconds,
                           held_bytes=prog.record.held_bytes)
    print(f"federated round ({name}) through train_federated's program, "
          f"captured: {out['captured']}", flush=True)
    del st, prog
    torch.cuda.empty_cache()
    return out


def check_fed_programs(by_path):
    """(c') ``train_federated`` at granite width, 2 rounds at chunk 2 on
    the sparse plan with buffered telemetry, codec None (B2) and int8+ef
    (B1): its round program captured once and replayed each round, then
    the same run under ``uncaptured()``: the population, the codec state,
    the losses, the telemetry rows and the launches ``==`` (the kernel
    once a leaf a round, counted through the replays)."""
    from repro_torch import telemetry
    from repro_torch.core import scanloop

    cfg = train_cfg()
    kw = dict(rounds=2, chunk=2)
    numbers = {}
    for codec, kernel in ((None, "consensus_update_pop"),
                          ("int8", "quant_consensus_pop")):
        label = codec or "none"
        runs = []
        for mode in ("captured", "eager"):
            tel = telemetry.Telemetry()
            ctx = (scanloop.uncaptured() if mode == "eager"
                   else contextlib.nullcontext())
            with ctx, scanloop.built_programs() as recs:
                (p, hist, _, st), got, wall, peak = fed_run(
                    cfg, codec=codec, telemetry=tel, **kw)
            runs.append(dict(hist=hist, got=got, wall=wall, peak=peak,
                             rows=tel.events(live_only=False), recs=recs))
            if mode == "captured":
                host = host_tree((p, st))
            else:
                same = same_as_host(host, (p, st))
            del p, st
            torch.cuda.empty_cache()
        cap, eag = runs
        del host
        programs = check_launcher_records(
            f"train_federated {label} (2 rounds, chunk 2)", cap["recs"],
            {"train_fl_round": kw["rounds"]})
        want = fed_expected(cfg, kernel, rounds=kw["rounds"])
        ok = (same and cap["hist"] == eag["hist"] and cap["rows"] == eag["rows"]
              and cap["got"] == eag["got"] == want)
        print(f"train_federated {label} captured == uncaptured (population, "
              f"codec state, losses {cap['hist']}, {len(cap['rows'])} rows, "
              f"launches {cap['got']}, expected {want}): {ok}; wall_s "
              f"captured / eager {cap['wall']} / {eag['wall']} (init "
              f"included); peak_memory_GB {cap['peak']} / {eag['peak']}",
              flush=True)
        if not ok:
            fail(f"train_federated {label}: the captured rounds differ from "
                 "the same rounds under uncaptured()")
        by_path[f"train_federated_program_{label}"] = cap["got"]
        numbers[label] = dict(wall_s=cap["wall"], eager_wall_s=eag["wall"],
                              peak_memory_GB=cap["peak"],
                              eager_peak_memory_GB=eag["peak"],
                              programs=programs)
    return numbers


def run_train_cli():
    """(e) the training CLI on the card as a subprocess, reduced granite:
    federated (2 rounds) and standard (2 steps)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    for args in (("--reduced", "--mode", "federated", "--rounds", "2"),
                 ("--reduced", "--steps", "2")):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            *args], capture_output=True, text=True,
                           timeout=600, env=env, cwd=root)
        tail = (r.stdout + r.stderr).strip().splitlines()[-3:]
        print(f"(e) python -m repro_torch.launch.train {' '.join(args)}: "
              f"exit {r.returncode} in {time.perf_counter() - t:.1f} s; "
              f"{tail}", flush=True)
        if r.returncode != 0:
            fail(f"train CLI {args} exited {r.returncode}: "
                 f"{(r.stdout + r.stderr)[-2000:]}")


def backward_row(source, replaces, shapes, headline):
    """A backward kernel's row of the ``kernels`` line: the headline
    shape's times and bound, the largest error over ``shapes``, every
    shape's row beside them."""
    h = shapes[headline]
    return dict(route="cuda", source=source, replaces=replaces,
                max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
                ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
                bound_by=h["bound_by"], library_ms=h["library_ms"],
                headline=headline, at_shapes=shapes)


#: the JAX package's differentiated paths whose gradient B3′ / B4′ compute
#: (XLA's, of the associative scan and of the attention dispatch)
B3_BWD_REPLACES = "src/repro/models/rglru.py:35"
B4_BWD_REPLACES = "src/repro/models/layers.py:198"


#: training figures with the plain-VJP backward (PERF.md: PR 27, review
#: call 2; PR 28, call 9; PR 20 for whisper's and the peaks), printed
#: beside this run's: other calls, possibly slower hosts
BEFORE_BACKWARD_KERNELS = {
    "granite-8b step ms (loop, captured)": 150.6,
    "granite-8b step ms (loop, eager)": 156.0,
    "granite-8b step peak GB": 15.9,
    "granite-8b federated round ms (eager, codec None)": 335.17,
    "whisper-large-v3 step ms (loop, captured)": "650-900",
    "whisper-large-v3 step peak GB": 26.7,
    "recurrentgemma-9b 3-layer step ms (loop, captured)": 325.1,
    "recurrentgemma-9b 3-layer step ms (loop, eager)": 486.8,
    "recurrentgemma-9b 3-layer step device ms (profiled)": 271.3,
    "recurrentgemma-9b 3-layer step peak GB": 55.7,
}


def beside_before(now):
    """Print ``now`` ({label: figure}) beside BEFORE_BACKWARD_KERNELS."""
    print("with B3′ / B4′ (this run) beside the plain-VJP backward (PERF.md, "
          "earlier calls): " + "; ".join(
              f"{k}: {v} vs {BEFORE_BACKWARD_KERNELS[k]}"
              for k, v in now.items()), flush=True)


def train_lm_phase(by_path, rows, generator):
    """Phase ``train_lm``: (a)–(e) of the module docstring."""
    t = time.perf_counter()
    grads, b4_err = check_lm_gradients(generator)
    for name in ("flash_attention", "rglru_scan"):
        rows[name]["at_training_shape"] = grads[name]
    rows["flash_attention_backward"] = backward_row(
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        B4_BWD_REPLACES, grads["flash_attention_backward"],
        "granite-8b bfloat16")
    rows["rglru_scan_backward"] = backward_row(
        "src/repro_torch/kernels/csrc/rglru_scan.cu", B3_BWD_REPLACES,
        dict({f"(2, 256, 512) h0 {k}": v
              for k, v in grads["rglru_scan_backward"].items()},
             **grads["rglru_scan_backward_extra"]),
        "(2, 256, 512) h0 float32")
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], b4_err)
    torch.cuda.empty_cache()
    print(f"(a) gradients: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    by_path["train_standard"], std = run_train_standard()
    print(f"(b) train_standard: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    fed = run_train_federated(by_path)
    fed["programs"] = check_fed_programs(by_path)
    for codec in (None, "int8"):
        fed[f"round_{codec}"] = measure_fl_round(codec)
    print(f"(c, d) train_federated and checkpoint: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    run_train_cli()
    print(f"(e) CLI: {time.perf_counter() - t:.2f} s", flush=True)
    beside_before({
        "granite-8b step ms (loop, captured)": std["ms_per_step"],
        "granite-8b step ms (loop, eager)": std["eager"]["ms_per_step"],
        "granite-8b step peak GB": std["peak_memory_GB"],
        "granite-8b federated round ms (eager, codec None)":
            fed["round_None"]["ms_per_round"]})
    return {"standard": std, "federated": fed}


def check_b4_whisper_shapes(generator):
    """(a) B4 at whisper-large-v3's shapes (H = K = 20, hd 64, bf16, T_enc
    = 1500 frames): served (batch 4), the encoder's unmasked
    self-attention and a 64-token prompt's cross-attention; trained (batch
    2), the encoder, the 448-token decoder's cross-attention and its causal
    self-attention (448 x 448), each with its gradient. Each against the
    plain version: the forward under the bf16 rounding gate, the
    gradients (autograd) under GRAD_BF16_REL of each one's largest entry;
    kernel, plain and SDPA (flash backend, causal or no mask) forward
    times and the operation bound 4·B·H·hd·(visible pairs); then B4′
    alone at the three trained shapes (:func:`b4_backward`). Returns the
    numbers by shape, the largest forward error and B4′'s rows."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref

    cfg = get_arch(WHISPER)
    H, hd, T = cfg.num_heads, cfg.head_dim_, cfg.encdec.encoder_seq_len
    Bs, Bt = WHISPER_SERVE["batch"], WHISPER_TRAIN["batch"]
    P, D = WHISPER_SERVE["prompt_len"], WHISPER_TRAIN["seq"]
    out, err = {}, 0.0
    for label, B, S, Tk, causal, grad in (
            ("encoder", Bs, T, T, False, False),
            ("cross", Bs, P, T, False, False),
            ("train_encoder", Bt, T, T, False, True),
            ("train_cross", Bt, D, T, False, True),
            ("train_self", Bt, D, D, True, True)):
        q, k, v = (torch.randn(B, n, H, hd, generator=generator,
                               device=DEVICE).to(torch.bfloat16)
                   .requires_grad_(grad) for n in (S, Tk, Tk))
        kw = dict(causal=causal, window=0, softcap=0.0)
        before = ops.flash_attention.launches
        got = ops.flash_attention(q, k, v, **kw)
        launched = ops.flash_attention.launches - before
        want = ref.attention_reference(q, k, v, **kw)
        gerr = []
        if grad:
            w = torch.randn(got.shape, generator=generator, device=DEVICE)
            n_bwd = ops.flash_attention_backward.launches
            dg = torch.autograd.grad((got.float() * w).sum(), (q, k, v))
            if ops.flash_attention_backward.launches != n_bwd + 1:
                fail(f"flash_attention whisper {label}: the gradient did "
                     "not launch B4′ once")
            dw = torch.autograd.grad((want.float() * w).sum(), (q, k, v))
            gerr = [_rel_err(a, b) for a, b in zip(dg, dw)]
            if not all(torch.isfinite(x.float()).all() for x in dg):
                fail(f"flash_attention whisper {label}: gradient not finite")
            del w, dg, dw
        with torch.no_grad():
            worst, e = _fwd_gate(got, want, q, k, v, kw)
        err = max(err, e)
        # the gradient is B4′'s, against autograd through the plain
        # forward: another route (b4_backward)
        if not torch.isfinite(got.float()).all() or worst > 1.0 \
                or launched != 1 or max(gerr, default=0.0) > \
                GRAD_ROUTE_FACTOR * GRAD_BF16_REL:
            fail(f"flash_attention at whisper's {label} shape: forward "
                 f"{worst} of its gate, gradients {gerr}, launches "
                 f"{launched}")
        del got, want
        q, k, v = (x.detach() for x in (q, k, v))
        flops = 4 * B * H * hd * visible_pairs(S, Tk, causal, 0)
        b4 = bound(*b4_work(q, k, causal, 0,
                            (2 * (2 * q.numel() + k.numel() + v.numel()),
                             flops)), BF16_FLOPS_PER_S)
        t_kernel = median_ms(lambda: ops.flash_attention(q, k, v, **kw))
        t_plain = median_ms(lambda: ref.attention_reference(q, k, v, **kw))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t_lib = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        print(f"flash_attention whisper {label} q {tuple(q.shape)} kv "
              f"{tuple(k.shape)} bf16 {'causal' if causal else 'no mask'}: "
              f"max |kernel - plain| = {e}, {worst:.4g} of the bf16 "
              f"rounding gate; dq, dk, dv (B4′) max |d| / max |autograd "
              f"through plain| = {gerr} (gate "
              f"{GRAD_ROUTE_FACTOR * GRAD_BF16_REL}); kernel_ms={t_kernel} "
              f"plain_ms="
              f"{t_plain} library_ms(SDPA)={t_lib} bound_ms={b4[0]} "
              f"({b4[1]}); {flops:.4g} flop, achieved "
              f"{flops / t_kernel / 1e9} TFLOP/s", flush=True)
        out[label] = dict(shape=[list(q.shape), list(k.shape)],
                          causal=causal, max_abs_err=e, gate_used=worst,
                          grad_rel_err=max(gerr, default=None),
                          ms=t_kernel, plain_ms=t_plain, bound_ms=b4[0],
                          bound_by=b4[1], library_ms=t_lib)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    # B4′ at the three trained shapes, f32 and bf16
    bwd = b4_backward_rows(generator, {
        f"whisper {label}": ((Bt, S, H, H, Tk, hd),
                             dict(causal=causal, window=0, softcap=0.0))
        for label, S, Tk, causal in (("train_encoder", T, T, False),
                                     ("train_cross", D, T, False),
                                     ("train_self", D, D, True))})
    return out, err, bwd


def zoo_serve(cfg, shape, by_path):
    """(b), (c) One full-size arch through the serving entry point
    (launches per phase exact, counted params), a profile of one prefill
    and 4 decode steps, and decode against the full forward at a cut
    depth. Returns the numbers."""
    t = time.perf_counter()
    by_path[f"serve_{cfg.name}"], numbers = run_serve(cfg, shape,
                                                      twin=True)
    torch.cuda.empty_cache()
    numbers["profile"] = profile_serve(cfg, shape=shape)
    torch.cuda.empty_cache()
    chk = ZOO_DECODE_CHECK[cfg.name]
    logits = {}
    for dtype, rms_gate in chk["runs"]:
        logits[dtype] = check_decode_vs_forward(
            dataclasses.replace(cfg, dtype=dtype), chk["layers"],
            chk["batch"], chk["prompt"], rms_gate=rms_gate)
        torch.cuda.empty_cache()
    if "float32" in logits:
        # the same weights and inputs: is bf16 decode's gap to bf16
        # forward the size of bf16 forward's own gap to the f32 forward?
        (_, f32), (d16, f16) = logits["float32"], logits["bfloat16"]
        numbers["bf16_witness"] = w = {
            "decode_vs_forward_bf16": float((d16 - f16).abs().max()),
            "decode_bf16_vs_forward_f32": float((d16 - f32).abs().max()),
            "forward_bf16_vs_forward_f32": float((f16 - f32).abs().max()),
            "rms_logits_f32": float(f32.square().mean().sqrt())}
        print(f"{cfg.name} bf16 rounding witness (max |d| at the last "
              f"position): {w}", flush=True)
    print(f"{cfg.name} served: {time.perf_counter() - t:.2f} s", flush=True)
    return numbers


def train_launches(cfg, rounds, per_round, with_logged_loss):
    """B3/B4 launches of ``rounds`` × ``per_round`` training forwards,
    each run twice with remat (forward and recompute), plus one forward
    without gradient a round (the federated trainer's logged loss); B3′
    and B4′ once per B3 / B4 layer of each training backward."""
    one = expected_prefill(cfg)
    twice = 2 if cfg.remat else 1
    n = rounds * (per_round * twice + (1 if with_logged_loss else 0))
    out = {k: v * n for k, v in one.items()}
    for k in ("rglru_scan", "flash_attention"):
        out[f"{k}_backward"] = one[k] * rounds * per_round
    return out


def zoo_train_standard(cfg, shape, profile=False, twin=False):
    """``train_standard`` counted from 0: each step's launches exact (B4
    and B3 in the forward and the remat recompute), finite losses, its
    step program captured once and replayed; ms a step (loop wall of
    steps 2.., sampling included) and peak memory; with ``profile``, one
    more step on a fixed batch profiled (kernels, busy share, B3/B4
    device time); with ``twin``, the run again under ``uncaptured()``
    ``==`` (:func:`standard_twin`) and the step program profiled too.
    Where the path launches a kernel, step 1 against the same step
    through the kernels' plain versions (``check_step1``)."""
    from repro_torch.core import scanloop
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import frontend

    per_step = train_launches(cfg, 1, 1, False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks, counts, gnorms = [], [], []

    def on_step(t, params, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(launch_counts())
        gnorms.append(float(m["grad_norm"]))

    zero_counts()
    t0 = time.perf_counter()
    with scanloop.built_programs() as recs:
        params, hist, ost = train.train_standard(
            cfg, device=DEVICE, callback=on_step, return_state=True, **shape)
    wall = time.perf_counter() - t0
    got = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    n_params = sum(v.numel() for v in params.values())
    programs = check_launcher_records(f"train_standard {cfg.name}", recs,
                                      {"train_step": shape["steps"]})
    eager = prof = prof_captured = None
    if twin:
        mine = dict(tree=host_tree((params, ost)), hist=hist, gnorms=gnorms)
        del params, ost
        eager, params, ost = standard_twin(cfg, shape, mine)
        del mine
    if profile:
        step, opt = make_train_step(cfg, lr=shape["lr"], clip_norm=1.0)
        st = {"p": params, "o": ost}
        del params, ost
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size,
                             (shape["batch"], shape["seq"] + 1),
                             generator=gen, device=DEVICE)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            batch["frames"] = frontend.audio_frame_embeddings(
                gen, cfg, shape["batch"], device=DEVICE)

        def one_step():
            st["p"], st["o"], _ = step(st["p"], st["o"], batch)

        one_step()
        prof = profile_step(one_step, f"train_standard_step_{cfg.name}")
        if twin:
            prof_captured = profile_step_program(
                cfg, shape, st.pop("p"), st.pop("o"), batch)
        del st
    else:
        del params, ost
    steps = [{k: b[k] - (a[k] if a else 0) for k in KERNELS}
             for a, b in zip([None] + counts, counts)]
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    print(f"train_standard {cfg.name} ({n_params} params, layers "
          f"{cfg.num_layers}, batch {shape['batch']} x {shape['seq']}"
          + (f", frames {cfg.encdec.encoder_seq_len}" if cfg.encdec
             else "") + f"): losses "
          f"{hist}, grad norms {gnorms}; ms per step (steps 2..) {step_ms}, "
          f"median {statistics.median(step_ms)}; peak_memory_GB={peak_gb} "
          f"peak_reserved_GB={reserved_gb}; "
          f"launches per step {steps} (expected {per_step}); wall_s (init "
          f"included) {wall}", flush=True)
    want = {k: v * shape["steps"] for k, v in per_step.items()}
    if not all(np.isfinite(hist)) or any(c != per_step for c in steps) \
            or got != want:
        fail(f"train_standard {cfg.name}: losses {hist}, launches {steps}")
    torch.cuda.empty_cache()
    step1 = (check_step1(cfg.name, (hist[0], gnorms[0]),
                         plain_step1(cfg, shape))
             if any(per_step.values()) else None)
    torch.cuda.empty_cache()
    return got, dict(ms_per_step=statistics.median(step_ms), step_ms=step_ms,
                     peak_memory_GB=peak_gb, losses=hist, grad_norms=gnorms,
                     launches_per_step=per_step, params=n_params,
                     profile=prof, step1_vs_plain=step1, programs=programs,
                     eager=eager, profile_captured=prof_captured)


def zoo_train_federated(cfg, shape, codec):
    """``train_federated`` on the sparse plan, counted from 0, buffered
    telemetry on: B1 (codec) or B2 (none) once per JAX leaf a round, B3/B4
    as the local steps' forwards and recomputes plus the logged loss; the
    Eq.-(11) estimate == the host formula at the counted params, and every
    telemetry row's joules == the host replay of its round (static
    clusters: every wire delivered). ms a round and peak memory."""
    from repro_torch import comms, telemetry
    from repro_torch.core import energy, topology
    from repro_torch.launch import train
    from repro_torch.rl.casestudy import delivered_comm_joules

    R, A, T = shape["rounds"], shape["agents"], shape["tasks"]
    per = A // T
    tel = telemetry.Telemetry()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    stacked, hist, E, _ = train.train_federated(
        cfg, consensus_plan="sparse", device=DEVICE, return_state=True,
        telemetry=tel, codec=codec, **shape)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = len(stacked)
    n_params = sum(v.numel() for v in stacked.values()) // A
    del stacked
    torch.cuda.empty_cache()
    kernel = "quant_consensus_pop" if codec else "consensus_update_pop"
    want = dict(train_launches(cfg, R, A * shape["local_steps"], True),
                **{kernel: R * leaves})
    c = comms.resolve_codec(codec) if codec else None
    topo = topology.clusters(T, per)
    ep = dataclasses.replace(energy.paper_calibrated("fig3"),
                             model_bits=32.0 * n_params,
                             devices_per_cluster=per,
                             B_i=shape["local_steps"])
    E_host = T * energy.fl_energy(ep, R, topology=topology.clusters(1, per),
                                  codec=c)
    replay = [delivered_comm_joules(topo, [np.asarray(topo.adjacency)], ep, c)
              for _ in range(R)]
    rows = [e["joules"] for e in tel.events(driver="fl")]
    print(f"train_federated {cfg.name} codec={codec} ({A} agents, "
          f"{shape['local_steps']} local steps of {shape['batch']} x "
          f"{shape['seq']}, {R} rounds, sparse): losses {hist}; {leaves} "
          f"leaves, launches {got} (expected {want}); E {E} J == host formula "
          f"{E_host}: {E == E_host}; row joules {rows} == host replay "
          f"{replay}: {rows == replay}; ms per round {wall * 1e3 / R} (init "
          f"included); peak_memory_GB={peak_gb}", flush=True)
    if got != want or E != E_host or rows != replay \
            or not all(np.isfinite(hist)):
        fail(f"train_federated {cfg.name} codec={codec}: launches {got} vs "
             f"{want}, E {E} vs {E_host}, rows {rows} vs {replay}")
    return got, dict(losses=hist, leaves=leaves, E=E, row_joules=rows,
                     ms_per_round_with_init=wall * 1e3 / R,
                     peak_memory_GB=peak_gb)


def zoo_phase(by_path, rows, generator):
    """Phase ``zoo``: (a)–(f) of the module docstring. Returns the
    numbers."""
    from repro_torch.configs import get_arch

    numbers = {}
    t = time.perf_counter()
    shapes, b4_err, b4p = check_b4_whisper_shapes(generator)
    rows["flash_attention"]["at_whisper_shapes"] = shapes
    rows["flash_attention_backward"] = backward_row(
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        B4_BWD_REPLACES,
        dict(rows["flash_attention_backward"]["at_shapes"], **b4p),
        rows["flash_attention_backward"]["headline"])
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], b4_err)
    hybrid = dataclasses.replace(get_arch(ARCH), num_layers=HYBRID_LAYERS)
    W = hybrid.rglru.lru_width or hybrid.d_model
    rows["rglru_scan"]["at_hybrid_training_shape"], b3p = b3_gradient(
        generator, HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"], W,
        with_h0=False)
    # B3′'s headline: the hybrid's training shape, f32, from zero
    shape = f"({HYBRID_TRAIN['batch']}, {HYBRID_TRAIN['seq']}, {W})"
    rows["rglru_scan_backward"] = backward_row(
        "src/repro_torch/kernels/csrc/rglru_scan.cu", B3_BWD_REPLACES,
        dict(rows["rglru_scan_backward"]["at_shapes"],
             **{f"{shape} {k}": v for k, v in b3p.items()}),
        f"{shape} float32")
    torch.cuda.empty_cache()
    print(f"(a) B4 at whisper's shapes, B3 at the hybrid's: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    for arch, shape in ((WHISPER, WHISPER_SERVE), (XLSTM, XLSTM_SERVE)):
        numbers[f"serve_{arch}"] = zoo_serve(get_arch(arch), shape, by_path)
    for arch, shape in ((WHISPER, WHISPER_TRAIN), (XLSTM, XLSTM_TRAIN)):
        t = time.perf_counter()
        by_path[f"train_standard_{arch}"], numbers[f"train_{arch}"] = \
            zoo_train_standard(get_arch(arch), shape,
                               profile=arch == WHISPER)
        print(f"train_standard {arch}: {time.perf_counter() - t:.2f} s",
              flush=True)
    for mode, cfg, shape, codec in (
            ("federated", get_arch(XLSTM), XLSTM_FED, None),
            ("federated", get_arch(XLSTM), XLSTM_FED, "int8"),
            ("standard", hybrid, HYBRID_TRAIN, None),
            ("federated", hybrid, HYBRID_FED, None)):
        t = time.perf_counter()
        key = f"train_{mode}_{cfg.name}_{cfg.num_layers}l" + (
            f"_{codec or 'none'}" if mode == "federated" else "")
        by_path[key], numbers[key] = (
            zoo_train_standard(cfg, shape, profile=True, twin=True)
            if mode == "standard" else zoo_train_federated(cfg, shape, codec))
        torch.cuda.empty_cache()
        print(f"{key}: {time.perf_counter() - t:.2f} s", flush=True)
    w, h = (numbers[f"train_{WHISPER}"],
            numbers[f"train_standard_{ARCH}_{HYBRID_LAYERS}l"])
    beside_before({
        "whisper-large-v3 step ms (loop, captured)": w["ms_per_step"],
        "whisper-large-v3 step peak GB": w["peak_memory_GB"],
        "recurrentgemma-9b 3-layer step ms (loop, captured)":
            h["ms_per_step"],
        "recurrentgemma-9b 3-layer step ms (loop, eager)":
            h["eager"]["ms_per_step"],
        "recurrentgemma-9b 3-layer step device ms (profiled)":
            (h["profile"] or {}).get("busy_ms", "not measured"),
        "recurrentgemma-9b 3-layer step peak GB": h["peak_memory_GB"]})
    return numbers


def run_analysis(src, smi):
    """The port's source rules and cost model on this checkout (engine
    rounds on the card), against the committed baseline; a new finding
    fails the smoke, and so does a cost layer in which B1 or B2 never
    launched."""
    from repro_torch.analysis.__main__ import main as analysis_main

    baseline = src / "repro_torch" / "analysis" / "baseline.json"
    zero_counts()
    t = time.perf_counter()
    code = analysis_main(["--strict", "--baseline", os.fspath(baseline),
                          "--device", DEVICE])
    wall = time.perf_counter() - t
    counts = launch_counts()
    print(f"analysis --layer all --device {DEVICE}: {wall:.2f} s wall "
          f"({smi}); launches {counts}", flush=True)
    if code != 0:
        fail(f"repro_torch.analysis --strict --baseline {baseline}: exit "
             f"{code} (a new finding, printed above)")
    if not counts["quant_consensus_pop"] or not counts["consensus_update_pop"]:
        fail(f"the cost layer's sparse rounds launched {counts}: B1 and B2 "
             "must both run on the card")
    zero_counts()


MESH_LM_TRAIN = dict(batch=4, seq=512, lr=1e-3)
#: ``mesh_lm`` (c): the hybrid at full width and one pattern period, and
#: whisper and xLSTM at full size, one training step and a prefill + 4
#: decode steps each on the 1 x 1 mesh against the same without one
MESH_LM_FAMILIES = (
    (ARCH, HYBRID_LAYERS, dict(batch=2, seq=512), dict(batch=2, prompt=256)),
    (WHISPER, None, dict(batch=2, seq=448), dict(batch=2, prompt=64)),
    (XLSTM, None, dict(batch=4, seq=256), dict(batch=2, prompt=256)))
MESH_LM_DECODE = 4
#: ``dryrun`` (b): the predicted peak within this band of the measured
#: one, and the roofline step time at most the median of this many steps
DRYRUN_PEAK_BAND = (0.8, 1.25)
DRYRUN_STEPS = 3
MESH_LM_PREFILL = dict(arch="qwen2-moe-a2.7b", layers=2, batch=1,
                       prompt=4096)


def timed(fn):
    """(value, ms) of one call of ``fn`` on the card, synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def mesh_lm_train(mesh, smi):
    """(a) one granite-8b step on the 1 x 1 mesh against the step without
    one, each from the same params and batch, run twice (the second
    timed)."""
    from repro_torch.data.pipeline import sharded_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.sharding import parallel

    cfg = train_cfg()
    per_step = 2 * cfg.num_layers if cfg.remat else cfg.num_layers
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    full = transformer.stack_params(transformer.init(cfg, generator=gen,
                                                     device=DEVICE))
    toks = torch.randint(0, cfg.vocab_size, (MESH_LM_TRAIN["batch"],
                                             MESH_LM_TRAIN["seq"] + 1),
                         generator=gen, device=DEVICE)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    local, specs = parallel.shard_params(full, cfg, mesh)
    tokens, labels = sharded_batch(batch["tokens"], batch["labels"], mesh)
    runs = {}
    for name, (step, opt), params, b in (
            ("no mesh", make_train_step(cfg, lr=MESH_LM_TRAIN["lr"]), full,
             batch),
            ("mesh 1x1", make_train_step(cfg, lr=MESH_LM_TRAIN["lr"],
                                         mesh=mesh, specs=specs), local,
             {"tokens": tokens, "labels": labels})):
        out = []
        for _ in range(2):
            p = {k: v.clone() for k, v in params.items()}
            st = opt.init(p)
            zero_counts()
            (_, _, m), ms = timed(lambda: step(p, st, b))
            out.append((float(m["loss"]), float(m["grad_norm"]), ms,
                        launch_counts()))
            del p, st
            torch.cuda.empty_cache()
        runs[name] = out
    (l0, g0, _, c0), (_, _, ms0, _) = runs["no mesh"]
    (l1, g1, _, c1), (_, _, ms1, _) = runs["mesh 1x1"]
    dl, dg = abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0)
    print(f"(a) {cfg.name} width {cfg.d_model} layers {cfg.num_layers} "
          f"batch {MESH_LM_TRAIN['batch']} x {MESH_LM_TRAIN['seq']}: mesh "
          f"1x1 step loss {l1} grad norm {g1} vs no mesh {l0} / {g0} (rel "
          f"{dl} / {dg}, gates {TRAIN_LOSS_REL} / {TRAIN_GNORM_REL}); ms a "
          f"step (second call) mesh {ms1} vs no mesh {ms0} ({smi}); B4 "
          f"launches {c1['flash_attention']} / {c0['flash_attention']}",
          flush=True)
    want = dict({n: 0 for n in KERNELS}, flash_attention=per_step,
                flash_attention_backward=cfg.num_layers)
    if not dl <= TRAIN_LOSS_REL or not dg <= TRAIN_GNORM_REL \
            or c0 != want or c1 != want:
        fail(f"mesh_lm train step: loss rel {dl}, grad norm rel {dg}, "
             f"launches {c1} / {c0} (want {want})")
    del full, local
    torch.cuda.empty_cache()
    return dict(loss_rel=dl, grad_norm_rel=dg, mesh_ms=ms1, plain_ms=ms0,
                launches=c1)


def mesh_lm_prefill(mesh, smi):
    """(b) a qwen2-moe-a2.7b prefill on the 1 x 1 mesh, its MoE routed
    per data shard (``moe_block`` given the mesh's view: the path the JAX
    package names ``moe_block_distributed``), against the same prefill
    without a mesh, run twice each (the second timed)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, transformer
    from repro_torch.sharding import parallel

    spec = MESH_LM_PREFILL
    cfg = dataclasses.replace(get_arch(spec["arch"]),
                              num_layers=spec["layers"], dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    full = transformer.stack_params(transformer.init(cfg, generator=gen,
                                                     device=DEVICE))
    toks = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"]),
                         generator=gen, device=DEVICE)
    local, specs = parallel.shard_params(full, cfg, mesh)
    tp = parallel.TensorParallel(mesh, specs)
    real, calls = moe.moe_block, []

    def counted(*a, **kw):
        # the per-data-shard calls: a view whose mesh has a data axis
        if kw.get("tp") is not None and kw["tp"].data_axes:
            calls.append(1)
        return real(*a, **kw)

    def prefill(params, **kw):
        caches = transformer.init_cache(cfg, spec["batch"], spec["prompt"],
                                        device=DEVICE)
        with torch.no_grad():
            return transformer.forward(params, cfg, toks, caches=caches,
                                       cache_index=0, last_only=True,
                                       **kw)[0]

    runs = {}
    moe.moe_block = counted
    try:
        for name, fn in (("moe_block", lambda: prefill(full)),
                         ("per data shard", lambda: prefill(local, tp=tp))):
            out = []
            for _ in range(2):
                zero_counts()
                logits, ms = timed(fn)
                out.append((logits[:, -1].float(), ms, launch_counts()))
            runs[name] = out
    finally:
        moe.moe_block = real
    (b, _, c0), (_, ms0, _) = runs["moe_block"]
    (a, _, c1), (_, ms1, _) = runs["per data shard"]
    worst = float(((a - b).abs() / (DECODE_TOL + DECODE_TOL * b.abs())).max())
    print(f"(b) {cfg.name} width {cfg.d_model} layers {cfg.num_layers} f32 "
          f"prefill {spec['batch']} x {spec['prompt']}: mesh 1x1, MoE per "
          f"data shard ({len(calls)} calls) vs no mesh: max "
          f"|d| {float((a - b).abs().max())}, {worst:.4g} of the "
          f"{DECODE_TOL} abs+rel gate; ms (second call) mesh {ms1} vs no "
          f"mesh {ms0} ({smi}); B4 launches {c1['flash_attention']} / "
          f"{c0['flash_attention']}", flush=True)
    want = dict({n: 0 for n in KERNELS}, flash_attention=cfg.num_layers)
    if not torch.isfinite(a).all() or worst > 1.0 or c0 != want \
            or c1 != want or len(calls) != 2 * cfg.num_layers:
        fail(f"mesh_lm prefill: {worst} of the gate, launches {c1} / {c0} "
             f"(want {want}), per-data-shard MoE calls {len(calls)}")
    del full, local
    torch.cuda.empty_cache()
    return dict(gate_share=worst, mesh_ms=ms1, plain_ms=ms0, launches=c1)


def mesh_lm_family(mesh, smi, arch, layers, train, serve):
    """(c) ``arch`` (cut to ``layers`` when given) on the 1 x 1 mesh: one
    ``make_train_step`` step given the mesh and the table's specs against
    the same step without a mesh (loss and gradient norm ``==``: at 1 x 1
    every region is the identity), and a prefill of ``serve["prompt"]``
    tokens plus ``MESH_LM_DECODE`` decode steps from caches placed by the
    table against the same serving without a mesh (max |d| 0), B3 and B4
    launching as many times on both paths."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.multichip import serve_logits
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import frontend
    from repro_torch.models.api import get_model
    from repro_torch.sharding import parallel

    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = get_model(cfg)

    def fresh():
        """The same params each call (seed 2), this rank's shards by the
        table: on a 1 x 1 mesh each shard is its whole leaf. Drawn anew
        for each run, so that only one copy is alive (the hybrid's step
        peaks near 56 GB)."""
        gen = torch.Generator(device=DEVICE).manual_seed(2)
        full = model.stack_params(model.init(cfg, generator=gen,
                                             device=DEVICE))
        return parallel.shard_params(full, cfg, mesh)

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    B, S = train["batch"], train["seq"]
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=DEVICE)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    frames = None
    if cfg.family == "encdec":
        frames = frontend.audio_frame_embeddings(gen, cfg, B, device=DEVICE)
        batch["frames"] = frames
    runs = {}
    for name, with_mesh in (("no mesh", False), ("mesh 1x1", True)):
        p, specs = fresh()
        torch.cuda.empty_cache()
        step, opt = make_train_step(
            cfg, lr=1e-3, **(dict(mesh=mesh, specs=specs) if with_mesh
                            else {}))
        st = opt.init(p)
        zero_counts()
        (_, _, m), ms = timed(lambda: step(p, st, batch))
        runs[name] = (float(m["loss"]), float(m["grad_norm"]), ms,
                      launch_counts())
        del p, st, m
        torch.cuda.empty_cache()
    (l0, g0, ms0, c0), (l1, g1, ms1, c1) = runs["no mesh"], runs["mesh 1x1"]
    sB, sP = serve["batch"], serve["prompt"]
    stoks = torch.randint(0, cfg.vocab_size, (sB, sP + MESH_LM_DECODE),
                          generator=gen, device=DEVICE)
    sframes = None if frames is None else frames[:sB]
    params, specs = fresh()
    tp = parallel.TensorParallel(mesh, specs)
    served = {}
    for name, kw in (("no mesh", {}), ("mesh 1x1", dict(tp=tp, mesh=mesh))):
        zero_counts()
        out, ms = timed(lambda: serve_logits(
            model, cfg, params, stoks, sframes, sP, MESH_LM_DECODE, **kw))
        served[name] = (out, ms, launch_counts())
    d = max(float(np.abs(a - b).max()) for a, b in zip(
        served["no mesh"][0], served["mesh 1x1"][0]))
    sc0, sc1 = served["no mesh"][2], served["mesh 1x1"][2]
    print(f"(c) {cfg.name} width {cfg.d_model} layers {cfg.num_layers}: "
          f"train {B} x {S} mesh 1x1 loss {l1} grad norm {g1} vs no mesh "
          f"{l0} / {g0}; ms (one call) mesh {ms1} vs {ms0}; launches "
          f"{c1} / {c0}; prefill {sB} x {sP} + {MESH_LM_DECODE} decode "
          f"steps: max |d| of the logits {d}, ms {served['mesh 1x1'][1]} "
          f"vs {served['no mesh'][1]}, launches {sc1} / {sc0} ({smi})",
          flush=True)
    uses = {"hybrid": ("rglru_scan", "flash_attention"),
            "encdec": ("flash_attention",)}.get(cfg.family, ())
    if (l1, g1) != (l0, g0) or d != 0.0 or c1 != c0 or sc1 != sc0 \
            or not np.isfinite(l0) or not all(c1[k] and sc1[k] for k in uses):
        fail(f"mesh_lm {cfg.name}: loss {l1} / {l0}, grad norm {g1} / {g0}, "
             f"serving max |d| {d}, launches {c1} / {c0}, {sc1} / {sc0}")
    del params
    torch.cuda.empty_cache()
    return dict(loss=l1, grad_norm=g1, mesh_ms=ms1, plain_ms=ms0,
                serve_max_abs_diff=d, launches={
                    k: c1[k] + sc1[k] for k in c1})


def mesh_lm_phase(smi):
    """The ``mesh_lm`` phase in its own NCCL group of world size 1."""
    from repro_torch.launch import mesh as mesh_lib

    store = Path(__file__).resolve().parent / "build" / "nccl_store_lm"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    mesh_lib.init_local_group(0, 1, str(store), backend="nccl")
    try:
        mesh = mesh_lib.make_host_mesh(1, 1)
        out = dict(train=mesh_lm_train(mesh, smi),
                   prefill=mesh_lm_prefill(mesh, smi))
        for arch, layers, train, serve in MESH_LM_FAMILIES:
            t = time.perf_counter()
            out[arch] = mesh_lm_family(mesh, smi, arch, layers, train, serve)
            print(f"(c) {arch}: {time.perf_counter() - t:.2f} s", flush=True)
        return out
    finally:
        mesh_lib.destroy_local_group()


def dryrun_predict():
    """The dry run's prediction of ``mesh_lm`` (a)'s granite step (2
    layers, batch 4 x 512, 1 x 1 mesh): ``python -m repro_torch.launch.
    dryrun`` in a subprocess on the CPU (its fake process group cannot
    share this process with the card's NCCL group); the report dict."""
    cfg = train_cfg()
    src = Path(__file__).resolve().parent / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cfg.name, "--shape", "train_4k", "--layers", str(cfg.num_layers),
         "--batch", str(MESH_LM_TRAIN["batch"]), "--seq-len",
         str(MESH_LM_TRAIN["seq"]), "--mesh", "1x1", "--json"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(src)))
    if out.returncode != 0:
        fail(f"dry run of the mesh_lm step: rc {out.returncode}\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    print(out.stdout.strip().splitlines()[-2], flush=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def dryrun_phase(smi):
    """(a) the dry run of granite-8b x train_4k on the 16 x 16 production
    mesh (a subprocess, CPU, meta tensors), its report printed; (b) the
    same code's prediction of ``mesh_lm`` (a)'s granite step against that
    step measured on the card: the predicted peak within
    ``DRYRUN_PEAK_BAND`` of ``max_memory_allocated``, and the H100
    roofline step time at most the median of ``DRYRUN_STEPS`` measured
    steps (a faster step would mean a wrong count), with the ratio and
    the joules a step at the card's power limit."""
    from repro_torch.core.energy import RooflineTerms, gpu_energy_params
    from repro_torch.data.pipeline import sharded_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.sharding import parallel

    src = Path(__file__).resolve().parent / "src"
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-8b", "--shape", "train_4k"], capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(src)))
    print(out.stdout.strip(), flush=True)
    if out.returncode != 0:
        fail(f"dryrun granite-8b x train_4k: rc {out.returncode}\n"
             f"{out.stderr[-2000:]}")
    print(f"(a) dry run granite-8b x train_4k on 16 x 16: "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    pred = dryrun_predict()
    cfg = train_cfg()
    store = Path(__file__).resolve().parent / "build" / "nccl_store_dry"
    if store.exists():
        store.unlink()
    mesh_lib.init_local_group(0, 1, str(store), backend="nccl")
    try:
        mesh = mesh_lib.make_host_mesh(1, 1)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        full = transformer.stack_params(transformer.init(
            cfg, generator=gen, device=DEVICE))
        p, specs = parallel.shard_params(full, cfg, mesh)
        del full
        toks = torch.randint(0, cfg.vocab_size, (MESH_LM_TRAIN["batch"],
                                                 MESH_LM_TRAIN["seq"] + 1),
                             generator=gen, device=DEVICE)
        tokens, labels = sharded_batch(toks[:, :-1], toks[:, 1:], mesh)
        batch = {"tokens": tokens, "labels": labels}
        step, opt = make_train_step(cfg, lr=MESH_LM_TRAIN["lr"], mesh=mesh,
                                    specs=specs)
        st = opt.init(p)
        torch.cuda.empty_cache()
        times, peaks = [], []
        for i in range(DRYRUN_STEPS + 1):        # the first warms up
            torch.cuda.reset_peak_memory_stats()
            (p, st, _), ms = timed(lambda: step(p, st, batch))
            if i:
                times.append(ms)
                peaks.append(torch.cuda.max_memory_allocated())
        del p, st
        torch.cuda.empty_cache()
    finally:
        mesh_lib.destroy_local_group()
    median_ms = statistics.median(times)
    peak = max(peaks)
    rt = RooflineTerms(flops=pred["flops"], hbm_bytes=pred["hbm_bytes"],
                       collective_bytes=0.0, chips=pred["chips"])
    watts = float(smi.split(",")[-1].strip().split()[0])
    ep = gpu_energy_params(rt, 4 * cfg.param_count(), chip_power=watts)
    ratio = pred["bytes_per_device"] / peak
    step_ratio = rt.step_time * 1e3 / median_ms
    joules = watts * median_ms / 1e3
    print(f"(b) {cfg.name} {cfg.num_layers} layers, {MESH_LM_TRAIN['batch']}"
          f" x {MESH_LM_TRAIN['seq']}, mesh 1x1: predicted peak "
          f"{pred['bytes_per_device']} B vs max_memory_allocated {peak} B "
          f"(ratio {ratio}, band {DRYRUN_PEAK_BAND}); roofline step "
          f"{rt.step_time * 1e3} ms ({rt.bottleneck}-bound: compute "
          f"{rt.t_compute * 1e3}, memory {rt.t_memory * 1e3}) vs the median "
          f"of {DRYRUN_STEPS} measured steps {median_ms} ms ({times}; "
          f"roofline / measured {step_ratio}); J a step at the card's "
          f"limit: measured {joules}, roofline {rt.step_time * watts} "
          f"(Eq.-(11) device role: {ep.Ek_C} J a gradient) ({smi})",
          flush=True)
    lo, hi = DRYRUN_PEAK_BAND
    if not lo <= ratio <= hi or rt.step_time * 1e3 > median_ms:
        fail(f"dryrun (b): predicted / measured peak {ratio} outside "
             f"{DRYRUN_PEAK_BAND}, or roofline {rt.step_time * 1e3} ms above "
             f"the median measured step {median_ms} ms")
    return dict(predicted_peak=pred["bytes_per_device"], peak=peak,
                peak_ratio=ratio, roofline_ms=rt.step_time * 1e3,
                median_ms=median_ms, step_ratio=step_ratio,
                joules_per_step=joules)


def main():
    phase("env")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs only on the card", file=sys.stderr)
        sys.exit(3)
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} is missing: run this script from the "
             "root of a checkout of the repository")
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build

    repro_torch.set_f32_matmul()
    set_rates()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global SMI
    SMI = smi

    phase("build")
    secs = build.build()
    for name in build.BUILD_LOGS:
        print(f"{name}: {ptxas_summary(name)}", flush=True)
    smem = build.library("flash_attention_bwd").flash_attention_bwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int], ctypes.c_longlong
    for bf16, kind in ((0, "f32 SIMT"), (1, "bf16 tensor-core")):
        print(f"flash_attention_bwd {kind} kernels' dynamic shared memory "
              "a block (bytes; dq pass, dk/dv pass): " + ", ".join(
                  f"hd {hd}: {smem(hd, 0, bf16)}, {smem(hd, 1, bf16)}"
                  for hd in (64, 128, 256)), flush=True)
    print(f"built in {secs:.1f} s ({os.fspath(build.BUILD_ROOT)})", flush=True)

    phase("analysis")
    run_analysis(src, smi)

    phase("kernels")
    cfg = get_arch("paper-dqn")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    pops, errs = check_kernels(cfg, gen)
    rows = time_kernels(pops, errs)

    phase("engine")
    check_engine(pops)

    phase("casestudy")
    by_path, walls = run_casestudy()

    phase("dynamic")
    check_dynamic_engine(pops)
    stamp("engine checks")
    check_dynamic_masks()
    check_dynamic_kernels(pops, errs)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]
    stamp("mask and kernel checks")
    dyn_paths, dyn_walls, dyn_int8 = run_dynamic_casestudy()
    by_path.update(dyn_paths)
    # the static int8 run is the script's first case study and carries its
    # warm-up; the codec=None pair are both warm
    print("dynamic / static case-study wall: " + ", ".join(
        f"codec={spec}: {dyn_walls[spec]} / {walls[spec]} = "
        f"{dyn_walls[spec] / walls[spec]}" for spec in walls) +
        " (static int8 is the first run: warm-up included)", flush=True)
    stamp("dynamic case study")
    profile_dynamic_round()

    phase("drivers")
    x = pops[K_POP]
    for path, label, fn, args in (
            ("drivers_scan_rounds_int8", "(a) scan_rounds telemetry",
             check_scan_rounds_telemetry, (x,)),
            ("drivers_fl_f32", "(b) FL drivers", check_fl_drivers, (x,)),
            ("drivers_casestudy_streaming_int8", "(c) streaming case study",
             run_streaming_casestudy, (dyn_int8,)),
            ("drivers_protocol", "(d) MTLProtocol", run_protocol, ())):
        t = time.perf_counter()
        by_path[path] = fn(*args)
        print(f"{label}: {time.perf_counter() - t:.2f} s", flush=True)
    del pops, x, dyn_int8
    torch.cuda.empty_cache()

    phase("paper")
    for label, fn in (("(a) C1", check_paper_c1),
                      ("(b) sweep", check_paper_sweep),
                      ("(c) meta round", measure_meta_round),
                      ("(d) async fleet", check_fleet)):
        t = time.perf_counter()
        by_path.update(fn())
        print(f"{label}: {time.perf_counter() - t:.2f} s", flush=True)

    phase("programs")
    t = time.perf_counter()
    by_path.update(programs_phase(stacked_params(cfg, K_POP, gen)))
    print(f"programs: {time.perf_counter() - t:.2f} s", flush=True)
    torch.cuda.empty_cache()

    phase("mesh")
    check_mesh_kernels(errs)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]
    for label, fn, args in (("(b) sharded", check_sharded, ()),
                            ("(c) distributed", check_distributed, (cfg,)),
                            ("(d) NCCL mesh", check_nccl_mesh, ()),
                            ("(e) memory", check_h1, ()),
                            ("(f) scale smoke", run_scale_smoke, ()),
                            ("(g) FL on a mesh", check_mesh_fl, (cfg, smi)),
                            ("(h) scan_rounds on a mesh", check_mesh_scan,
                             (cfg, smi)),
                            ("(i) train_federated on a mesh",
                             check_mesh_train, (smi,))):
        t = time.perf_counter()
        by_path.update(fn(*args) or {})
        torch.cuda.empty_cache()
        print(f"{label}: {time.perf_counter() - t:.2f} s", flush=True)

    phase("profile")
    profile_round()

    phase("lm_kernels")
    lm_cfg = get_arch(ARCH)
    rows.update(check_lm_kernels(lm_cfg, gen))
    torch.cuda.empty_cache()
    b4_shapes, b4_err = check_b4_transformer_shapes(gen)
    rows["flash_attention"]["at_transformer_shapes"] = b4_shapes
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], b4_err)
    check_b4_backward_memory(gen)

    phase("serve")
    by_path["serve"], _ = run_serve(lm_cfg, twin=True)
    torch.cuda.empty_cache()
    profile_serve(lm_cfg)
    torch.cuda.empty_cache()
    check_decode_vs_forward(lm_cfg, len(lm_cfg.rglru.block_pattern))
    torch.cuda.empty_cache()

    phase("serve_lm")
    t = time.perf_counter()
    serving = serve_lm_phase(by_path)
    print(f"serve_lm: {time.perf_counter() - t:.2f} s; serving numbers "
          f"{json.dumps(serving)}", flush=True)
    torch.cuda.empty_cache()

    phase("train_lm")
    t = time.perf_counter()
    training = train_lm_phase(by_path, rows, gen)
    print(f"train_lm: {time.perf_counter() - t:.2f} s; training numbers "
          f"{json.dumps(training)}", flush=True)
    torch.cuda.empty_cache()

    phase("zoo")
    t = time.perf_counter()
    zoo = zoo_phase(by_path, rows, gen)
    print(f"zoo: {time.perf_counter() - t:.2f} s; zoo numbers "
          f"{json.dumps(zoo)}", flush=True)
    torch.cuda.empty_cache()

    phase("mesh_lm")
    t = time.perf_counter()
    meshed = mesh_lm_phase(smi)
    for part in ("train", "prefill"):
        by_path[f"mesh_lm_{part}"] = meshed[part].pop("launches")
    for arch, *_ in MESH_LM_FAMILIES:
        by_path[f"mesh_lm_{arch}"] = meshed[arch].pop("launches")
    print(f"mesh_lm: {time.perf_counter() - t:.2f} s; mesh numbers "
          f"{json.dumps(meshed)}", flush=True)

    phase("dryrun")
    t = time.perf_counter()
    dry = dryrun_phase(smi)
    print(f"dryrun: {time.perf_counter() - t:.2f} s; dry-run numbers "
          f"{json.dumps(dry)}", flush=True)

    # launches: the sum over the main paths (the case study's runs, the
    # drivers' runs, the paper's runs, the serving run), each counted from
    # 0 in its own run;
    # launches_by_path keeps them apart
    kernels = [dict(name=n, launches=sum(p[n] for p in by_path.values()),
                    launches_by_path={k: p[n] for k, p in by_path.items()},
                    **rows[n]) for n in KERNELS]
    print(f"all phases done at t = {time.perf_counter() - T_START:.1f} s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
