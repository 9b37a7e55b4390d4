"""Clustered multi-task network model — paper Sect. II.

K devices form M clusters C_i; cluster i learns task τ_i (Eq. 1). A subset
Q_τ of Q ≤ M tasks is used for MAML meta-training (Eq. 2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TaskSpec:
    """One task τ_i: a name and a sampler of batches."""
    name: str
    sample: Callable = None
    meta: dict = field(default_factory=dict)

    def __hash__(self):
        return hash(self.name)


@dataclass(frozen=True)
class ClusterNetwork:
    """The clustered multi-task topology: device k ∈ C_i learns τ_i."""

    num_tasks: int                        # M
    devices_per_cluster: int = 2          # |C_i|
    meta_task_ids: Tuple[int, ...] = ()   # Q_τ ⊆ {0..M-1}

    @property
    def K(self) -> int:
        return self.num_tasks * self.devices_per_cluster

    @property
    def Q(self) -> int:
        return len(self.meta_task_ids)

    def cluster_of(self, device: int) -> int:
        return device // self.devices_per_cluster

    def devices_of(self, task: int) -> Sequence[int]:
        c = self.devices_per_cluster
        return list(range(task * c, (task + 1) * c))

    def neighbors_of(self, device: int) -> Sequence[int]:
        """In-cluster neighbourhood N_{k,i} (all-to-all in the cluster)."""
        return [d for d in self.devices_of(self.cluster_of(device))
                if d != device]

    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.K, self.K), bool)
        for k in range(self.K):
            for h in self.neighbors_of(k):
                A[k, h] = True
        return A

    def topology(self):
        """The population's graph (per-task SL clusters)."""
        from repro_torch.core import topology as topo_lib
        return topo_lib.from_cluster_network(self)

    def cluster_topology(self):
        """One cluster C_i's graph (drives per-task Eq.-(11) pricing)."""
        from repro_torch.core import topology as topo_lib
        return topo_lib.clusters(1, self.devices_per_cluster)


class TaskRegistry:
    """Name -> TaskSpec registry with deterministic ordering."""

    def __init__(self):
        self._tasks: Dict[str, TaskSpec] = {}

    def add(self, task: TaskSpec) -> TaskSpec:
        self._tasks[task.name] = task
        return task

    def __getitem__(self, name: str) -> TaskSpec:
        return self._tasks[name]

    def __len__(self):
        return len(self._tasks)

    def names(self):
        return sorted(self._tasks)

    def ordered(self):
        return [self._tasks[n] for n in self.names()]
