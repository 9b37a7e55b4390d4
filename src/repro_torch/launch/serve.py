"""Serving launcher: batched prefill + greedy decode with KV caches (and
recurrent states for the hybrid and xLSTM), on random weights drawn from
``--seed``. Serves every decoder LM: ``dense``, ``moe``, ``vlm``,
``hybrid``, ``ssm`` (xLSTM) and ``encdec`` (whisper, whose encoder reads
stub audio frames drawn by :mod:`repro_torch.models.frontend` from the
run's generator; the prompt is its decoder's).

Usage (on the card; ``--device cpu --reduced`` for a CPU-sized run):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --batch 4 --prompt-len 4096 --gen 32
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict

import torch

import repro_torch
from repro_torch.configs import get_arch, reduced
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
    prefill_ms: float
    decode_ms_per_token: float      # per decode step (the whole batch)
    launches: Dict[str, Dict[str, int]]   # phase -> kernel -> launches
    n_params: int                   # parameters of the served model


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    return {n: fn.launches for n, fn in KERNELS.items()}


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device="cuda", verbose: bool = True) -> ServeResult:
    model = get_model(cfg)
    if model.init_cache is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) is not a decoder LM")
    repro_torch.set_f32_matmul()
    rng = torch.Generator(device=device).manual_seed(seed)
    params = model.cast_for_serving(
        model.init(cfg, generator=rng, device=device), cfg)
    caches = model.init_cache(cfg, batch, prompt_len + gen, device=device)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=rng, device=device)
    bd = {"tokens": prompts}
    if cfg.family == "encdec":
        bd["frames"] = frontend.audio_frame_embeddings(rng, cfg, batch,
                                                       device=device)

    counts = [_launches()]
    _sync(device)
    t0 = time.perf_counter()
    last_logits, caches = prefill(params, caches, bd)
    nxt = torch.argmax(last_logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(device)
    t_prefill = time.perf_counter() - t0
    counts.append(_launches())

    out = [nxt]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        nxt, caches = decode(params, caches, {"tokens": nxt,
                                              "cache_index": prompt_len + i})
        out.append(nxt)
    _sync(device)
    t_decode = time.perf_counter() - t0
    counts.append(_launches())
    launches = {phase: {n: counts[k + 1][n] - counts[k][n] for n in KERNELS}
                for k, phase in enumerate(("prefill", "decode"))}
    res = ServeResult(tokens=torch.cat(out, dim=1), last_logits=last_logits,
                      prefill_ms=t_prefill * 1e3,
                      decode_ms_per_token=t_decode / max(gen - 1, 1) * 1e3,
                      launches=launches, n_params=count_params(params))
    if verbose:
        print(f"{cfg.name}: {res.n_params:,} params")
        print(f"prefill {batch}x{prompt_len}: {res.prefill_ms:.1f} ms")
        print(f"decode {gen - 1} steps: {t_decode * 1e3:.1f} ms "
              f"({res.decode_ms_per_token:.2f} ms/tok/batch)")
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
