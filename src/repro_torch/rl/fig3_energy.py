"""Fig. 3 on the port: energy footprints and rounds, MAML (t0=210) vs
FL-only (t0=0). The port's copy of ``benchmarks/fig3_energy.py``.

Reads the port's fig4 JSON if present (fig4's grid subsumes fig3);
otherwise runs the two points directly through
:func:`repro_torch.rl.fig4_tradeoff.run`. Prints the per-task energy bars
and reports the paper's headline claims (reported, not gated):
  * total E(MAML) ≤ E(no-MAML) / 2     (">= 2x" claim)
  * per-round data-center energy > per-round device energy

Run (on the card):
    PYTHONPATH=src python -m repro_torch.rl.fig3_energy --seeds 1 \\
        --plan sparse
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import energy
from repro_torch.rl import fig4_tradeoff

FIG4_PATH = fig4_tradeoff.DEFAULT_OUT
FIG3_PATH = "build/results/torch_fig3.json"


def report(mean_rounds_210, mean_rounds_0, p=None):
    p = p or energy.paper_calibrated("fig3")
    E_ml = energy.maml_energy(p, 210, 3)
    E_fl = [energy.fl_energy(p, t) for t in mean_rounds_210]
    E_fl0 = [energy.fl_energy(p, t) for t in mean_rounds_0]
    total = E_ml + sum(E_fl)
    total0 = sum(E_fl0)
    print("=== Fig. 3 reproduction (paper values in brackets) ===")
    print(f"E_ML(t0=210, Q=3)       = {E_ml/1e3:7.1f} kJ   [74]")
    print(f"t_i (MAML)              = {[round(t,1) for t in mean_rounds_210]}"
          f"   [7..32]")
    print(f"t_i (no MAML)           = {[round(t,1) for t in mean_rounds_0]}"
          f"   [24..380]")
    print(f"sum E_FL (MAML)         = {sum(E_fl)/1e3:7.1f} kJ   [32]")
    print(f"TOTAL (MAML)            = {total/1e3:7.1f} kJ   [106]")
    print(f"TOTAL (no MAML)         = {total0/1e3:7.1f} kJ   [227]")
    ratio = total0 / total
    print(f"energy reduction        = {ratio:.2f}x   [>= 2x claim]")
    per_round_dc = (energy.maml_energy(p, 210, 3)
                    - energy.maml_energy(p, 209, 3))
    per_round_dev = energy.fl_energy(p, 1.0)
    print(f"per-round: data center {per_round_dc:.0f} J > device "
          f"{per_round_dev:.0f} J : {per_round_dc > per_round_dev}")
    return {"E_ML_kJ": E_ml / 1e3,
            "E_FL_kJ": [e / 1e3 for e in E_fl],
            "total_maml_kJ": total / 1e3,
            "total_fl_only_kJ": total0 / 1e3,
            "reduction": ratio}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--plan", default="auto",
                    help="consensus plan of the sweep when it runs: auto | "
                         "dense | sparse (or dense-xla | sparse-pallas)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if os.path.exists(FIG4_PATH):
        with open(FIG4_PATH) as f:
            data = json.load(f)
    else:
        data = fig4_tradeoff.run(seeds=a.seeds, max_rounds=a.max_rounds,
                                 t0_grid=(0, 210), plan=a.plan,
                                 device=a.device, verbose=True)
    mr = data["mean_rounds"]
    out = report(mr["210"], mr["0"])
    os.makedirs(os.path.dirname(FIG3_PATH), exist_ok=True)
    with open(FIG3_PATH, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
