"""Serve reduced assigned architectures with batched requests: prefill +
greedy decode through the KV-cache serve path, including a sliding-window
arch whose cache is the circular window buffer. The port's twin of the
JAX package's ``examples/serve_lm.py``.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.serve import serve

ARCHS = ("stablelm-3b", "h2o-danube-3-4b", "recurrentgemma-9b")


def run(device="cuda", verbose: bool = True) -> dict:
    """Serve each arch reduced, at batch 2, prompt 32 and 8 generated
    tokens; returns the ``ServeResult`` by arch."""
    results = {}
    for arch in ARCHS:
        cfg = reduced(get_arch(arch))
        if verbose:
            swa = f", SWA {cfg.sliding_window}" if cfg.sliding_window else ""
            print(f"== {arch} (reduced: {cfg.num_layers}L d={cfg.d_model}"
                  f"{swa}) ==")
        results[arch] = serve(cfg, batch=2, prompt_len=32, gen=8,
                              device=device, verbose=verbose)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
