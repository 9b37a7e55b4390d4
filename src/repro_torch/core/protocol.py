"""The paper's two-stage protocol result and its energy bill (Sect. III):
stage 1 meta-trains for t0 rounds, stage 2 adapts each task until it hits
its target after t_i rounds; Eqs. (8)–(12) price both."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core import energy
from repro_torch.core import topology as topo_lib


@dataclass
class ProtocolResult:
    t0: int
    rounds_per_task: List[int]              # t_i, i = 1..M
    meta_history: List[float]
    fl_histories: List[List[float]]
    energy_params: energy.EnergyParams
    Q: int
    cluster_topology: Optional[topo_lib.Topology] = None
    #: exchange codec (spec or Codec): prices each stage-2 sidelink
    #: message at its wire size in Eq. (11)
    codec: object = None
    #: per-task Eq.-(11) comm joules measured on the links actually up;
    #: None for static topologies, where the modeled term is exact
    fl_comm_joules_measured: Optional[List[float]] = None

    @property
    def E_FL_comm(self) -> List[float]:
        """Per-task Eq.-(11) comm term."""
        if self.fl_comm_joules_measured is not None:
            return list(self.fl_comm_joules_measured)
        return [energy.fl_comm_energy(self.energy_params, t,
                                      self.cluster_topology, self.codec)
                for t in self.rounds_per_task]

    @property
    def E_ML(self) -> float:
        return energy.maml_energy(self.energy_params, self.t0, self.Q)

    @property
    def E_FL(self) -> List[float]:
        return [energy.fl_learning_energy(self.energy_params, t,
                                          self.cluster_topology) + c
                for t, c in zip(self.rounds_per_task, self.E_FL_comm)]

    @property
    def E_total(self) -> float:
        return self.E_ML + sum(self.E_FL)

    def summary(self) -> Dict:
        from repro_torch.comms import codecs
        codec = codecs.get_codec(self.codec)
        return {
            "t0": self.t0,
            "t_i": self.rounds_per_task,
            "codec": codec.name if codec is not None else None,
            "E_ML_kJ": self.E_ML / 1e3,
            "E_FL_kJ": [e / 1e3 for e in self.E_FL],
            "E_total_kJ": self.E_total / 1e3,
        }
