"""Staleness-tolerant asynchronous consensus under agent churn: the
port's twin of ``examples/async_fleet.py``.

Real wireless fleets have duty-cycled radios, heavy-tail stragglers,
and agents that join or leave mid-protocol. Each fleet attaches an
``AgentProcess`` to a consensus engine and runs the same round loop the
lockstep protocol uses (``scan_rounds``): sleeping agents freeze bitwise,
awake receivers mix their neighbours' last-published params weighted by
staleness (``staleness_decay**age``, hard-dropped past ``tau`` rounds),
and the per-round telemetry ledger bills only the wires actually
DELIVERED, reconciling exactly with a host-side availability replay.

The fleet's params are standard normal from numpy (seed 0), so the JAX
example can be fed the same array.

Run:  PYTHONPATH=src python -m repro_torch.launch.async_fleet [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import telemetry as telemetry_lib
from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ConsensusEngine

K, ROUNDS = 8, 12


def fleet_params(device, seed: int = 0):
    """The fleet's stacked (K, 32) params, standard normal from numpy."""
    w = np.random.default_rng(seed).standard_normal((K, 32))
    return {"w": torch.from_numpy(w.astype(np.float32)).to(device)}


def processes():
    """(label, AgentProcess or None for lockstep) of the five fleets."""
    return (
        ("lockstep (baseline)", None),
        ("60% duty cycle", topo_lib.AgentProcess.bernoulli(0.6, seed=1)),
        ("heavy-tail stragglers",
         topo_lib.AgentProcess.straggler(K, scale=0.3, seed=1)),
        ("staggered arrivals",
         topo_lib.AgentProcess.arrival(np.arange(K) * 2)),
        ("mass departure",
         topo_lib.AgentProcess.departure(np.full(K, ROUNDS - 4))),
    )


def run(agents, label, stacked, *, plan: str = "auto"):
    """``ROUNDS`` rounds of ``scan_rounds`` on ring(K) over the int8 wire
    (τ = 3, λ = 0.9 when ``agents`` is set) with buffered telemetry;
    prints the example's line. Returns (engine, mixed params, telemetry)."""
    kw = ({"agents": agents, "tau": 3, "staleness_decay": 0.9}
          if agents is not None else {})
    eng = ConsensusEngine(topo_lib.ring(K), codec="int8", plan=plan, **kw)
    tel = telemetry_lib.Telemetry()
    mixed, _ = eng.scan_rounds(stacked, rounds=ROUNDS, telemetry=tel)
    ev = tel.events(driver="consensus")
    joules = sum(e["joules"] for e in ev)
    spread = float(np.std(mixed["w"].cpu().numpy(), axis=0).mean())
    print(f"{label:>22}: active/round "
          f"{[e['n_active'] for e in ev]}  max wire age "
          f"{max(e['max_age'] for e in ev)}  comm {joules:.1f} J  "
          f"disagreement {spread:.4f}")
    return eng, mixed, tel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plan", default="auto",
                    help="consensus plan: auto | dense | sparse "
                         "(or dense-xla | sparse-pallas)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    stacked = fleet_params(a.device)
    for label, agents in processes():
        run(agents, label, stacked, plan=a.plan)


if __name__ == "__main__":
    main()
