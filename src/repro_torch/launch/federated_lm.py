"""The paper's clustered federated MTL protocol on a reduced granite-8b,
with the sidelink-efficiency knob (bf16 consensus messages) that the
Eq.-(11) energy model prices directly — the port's twin of the JAX
package's ``examples/federated_lm.py``.

Run (on the card; ``--device cpu`` on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.federated_lm
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.train import train_federated


def run(*, rounds: int = 5, device="cuda", **kw):
    """f32 then bf16 consensus; returns ``{"f32": (losses, E), "bf16":
    (losses, E)}``. ``kw`` overrides ``train_federated``'s arguments."""
    cfg = reduced(get_arch("granite-8b"), num_layers=2, d_model=128)
    args = dict(rounds=rounds, agents=4, tasks=2, local_steps=4, batch=2,
                seq=64, lr=1e-3, device=device)
    args.update(kw)
    print("== f32 consensus messages ==")
    _, hist32, E32 = train_federated(cfg, **args)
    print("\n== bf16 consensus messages (half the sidelink bytes) ==")
    _, hist16, E16 = train_federated(cfg, consensus_dtype=torch.bfloat16,
                                     **args)
    print(f"\nloss f32 {hist32[-1]:.3f} vs bf16 {hist16[-1]:.3f}; "
          f"comm energy {E32/1e3:.2f} kJ -> {E16/1e3:.2f} kJ")
    return {"f32": (hist32, E32), "bf16": (hist16, E16)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(rounds=args.rounds, device=args.device)


if __name__ == "__main__":
    main()
