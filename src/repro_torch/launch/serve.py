"""Serving launcher: batched prefill + greedy decode with KV caches (and
recurrent states for the hybrid and xLSTM), on random weights drawn from
``--seed``. Serves every decoder LM: ``dense``, ``moe``, ``vlm``,
``hybrid``, ``ssm`` (xLSTM) and ``encdec`` (whisper, whose encoder reads
stub audio frames drawn by :mod:`repro_torch.models.frontend` from the
run's generator; the prompt is its decoder's).

The prefill and the decode step are two :func:`repro_torch.core.scanloop.
donating_graph` programs built per :func:`serve` call, as the JAX package
builds two ``jax.jit`` programs per call. On the card each program's first
call runs eagerly and is then captured into a CUDA graph, which later calls
replay: the caches are donated (updated in place; the prefill's caches are
the decode program's carry, so nothing is copied between them), the params
are kept (read in place, never cloned), the batch is a static input, and
the decode position is a 0-d int32 device tensor read one entry a step from
one ``arange`` made up front: no host copy and one graph for every token.
The prefill runs once a call, so its graph is never replayed here: it is
dropped, and its memory pool freed, before the decode is captured. On the
CPU, and under ``scanloop.uncaptured()`` on the card, the same programs run
eagerly.

Usage (on the card; ``--device cpu --reduced`` for a CPU-sized run):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --batch 4 --prompt-len 4096 --gen 32
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch

import repro_torch
from repro_torch.configs import get_arch, reduced
from repro_torch.core import scanloop
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import frontend
from repro_torch.models.api import count_params, get_model

#: the kernel wrappers the serving path launches
KERNELS = {"rglru_scan": ops.rglru_scan,
           "flash_attention": ops.flash_attention}


@dataclass
class ServeResult:
    tokens: torch.Tensor            # (B, gen) int32 greedy tokens
    last_logits: torch.Tensor       # (B, 1, V) prefill logits, last position
    #: the prefill's one call (a program's first call: eager), its
    #: capture excluded
    prefill_ms: float
    #: per decode step (the whole batch) after the first: the replays (on
    #: the CPU: eager calls); with one step, that step, capture excluded
    decode_ms_per_token: float
    launches: Dict[str, Dict[str, int]]   # phase -> kernel -> launches
    n_params: int                   # parameters of the served model
    #: program -> seconds its capture took (its first call excluded; 0
    #: eager)
    capture_s: Dict[str, float]
    #: program -> its :class:`repro_torch.core.scanloop.ProgramRecord`
    programs: Dict[str, Any]
    caches: Any                     # the caches after the last decode step


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    return {n: fn.launches for n, fn in KERNELS.items()}


def serving_programs(cfg):
    """``(prefill, decode)``: the two launcher programs of one
    :func:`serve` call. ``prefill(params, caches, batch) -> ((caches,),
    (last logits (B, 1, V), greedy next token (B, 1) int32))`` and
    ``decode(params, caches, batch{tokens, cache_index}) -> ((caches,),
    next token)``; ``caches`` donated, ``params`` kept."""
    prefill_step, decode_step = make_prefill_step(cfg), make_decode_step(cfg)

    def prefill(params, caches, batch):
        logits, caches = prefill_step(params, caches, batch)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return (caches,), (logits, nxt)

    def decode(params, caches, batch):
        nxt, caches = decode_step(params, caches, batch)
        return (caches,), nxt

    kw = dict(donate_argnums=(1,), keep_argnums=(0,))
    return (scanloop.donating_graph(prefill, name="serve_prefill", **kw),
            scanloop.donating_graph(decode, name="serve_decode", **kw))


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device="cuda", verbose: bool = True) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen - 1`` greedy steps, through :func:`serving_programs`."""
    model = get_model(cfg)
    if model.init_cache is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) is not a decoder LM")
    repro_torch.set_f32_matmul()
    rng = torch.Generator(device=device).manual_seed(seed)
    params = model.cast_for_serving(
        model.init(cfg, generator=rng, device=device), cfg)
    caches = model.init_cache(cfg, batch, prompt_len + gen, device=device)
    prefill, decode = serving_programs(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=rng, device=device)
    bd = {"tokens": prompts}
    if cfg.family == "encdec":
        bd["frames"] = frontend.audio_frame_embeddings(rng, cfg, batch,
                                                       device=device)
    # every decode position, on the device once: step i reads entry i
    # (the reference's ``jnp.int32(prompt_len + i)``)
    positions = torch.arange(prompt_len, prompt_len + max(gen - 1, 0),
                             dtype=torch.int32, device=device)

    counts = [_launches()]
    _sync(device)
    t0 = time.perf_counter()
    (caches,), (last_logits, nxt) = prefill(params, caches, bd)
    _sync(device)
    t_prefill = time.perf_counter() - t0 - prefill.record.capture_seconds
    counts.append(_launches())
    programs = {"prefill": prefill.record, "decode": decode.record}
    # never replayed in this call: its graph and pool go before the
    # decode's capture (its outputs and the caches live on without it)
    del prefill

    # a replay's output lives in the graph pool until the next replay:
    # each token is copied out
    out = [nxt]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        if i == 1:
            # the clock covers the steps after the first (its capture's)
            _sync(device)
            t0 = time.perf_counter()
        (caches,), nxt = decode(params, caches, {"tokens": nxt,
                                                 "cache_index": positions[i]})
        out.append(nxt.clone())
    _sync(device)
    t_decode = time.perf_counter() - t0
    if gen == 2:
        t_decode -= decode.record.capture_seconds
    counts.append(_launches())
    launches = {phase: {n: counts[k + 1][n] - counts[k][n] for n in KERNELS}
                for k, phase in enumerate(("prefill", "decode"))}
    res = ServeResult(tokens=torch.cat(out, dim=1), last_logits=last_logits,
                      prefill_ms=t_prefill * 1e3,
                      decode_ms_per_token=t_decode / max(gen - 2, 1) * 1e3,
                      launches=launches, n_params=count_params(params),
                      capture_s={k: r.capture_seconds
                                 for k, r in programs.items()},
                      programs=programs, caches=caches)
    if verbose:
        print(f"{cfg.name}: {res.n_params:,} params")
        print(f"prefill {batch}x{prompt_len}: {res.prefill_ms:.1f} ms "
              f"(capture {res.capture_s['prefill']:.2f} s apart)")
        print(f"decode {gen - 1} steps: {res.decode_ms_per_token:.2f} "
              f"ms/tok/batch after the first (capture "
              f"{res.capture_s['decode']:.2f} s apart)")
        print(f"generated shape: {tuple(res.tokens.shape)}")
        print(f"kernel launches: {launches}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
