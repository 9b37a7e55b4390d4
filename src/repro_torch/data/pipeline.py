"""Synthetic task-conditioned token pipeline: the port of the JAX
package's ``data/pipeline.py``.

Per-task Markov chains over the vocabulary give token streams with
learnable structure: tasks share a backbone transition matrix and differ
by a per-task perturbation (the paper's "different but related tasks").
The tables are the JAX package's numpy code, so they are equal (``==``).
Rollouts draw from an explicit ``torch.Generator`` on its device
(Gumbel-max categorical steps, as ``jax.random.categorical``), so the
draws differ from ``jax.random``'s. :func:`sharded_batch` gives a rank
its rows of a batch on a data x model mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TaskTokenDistribution:
    """Per-task Markov chain: P_task = normalize(P_base + strength * D_task)."""

    vocab_size: int
    num_tasks: int
    order_strength: float = 4.0
    task_strength: float = 2.0
    seed: int = 0

    def transition(self, task_id: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        V = min(self.vocab_size, 256)   # active vocabulary (rest unused)
        base = rng.exponential(1.0, (V, V)) \
            + self.order_strength * np.eye(V)[:, ::-1]
        trng = np.random.default_rng(self.seed + 1000 + task_id)
        pert = trng.exponential(self.task_strength, (V, V)) \
            * (trng.random((V, V)) < 0.05)
        P = base + pert
        return P / P.sum(axis=1, keepdims=True)

    def transitions(self) -> np.ndarray:
        """(num_tasks, V, V) stacked transition tables (host-computed)."""
        return np.stack([self.transition(t) for t in range(self.num_tasks)])

    def log_tables(self, device) -> torch.Tensor:
        """log(P + 1e-9) of every task, (num_tasks, V, V) f32 on
        ``device``, made once per distribution and device."""
        return _log_tables(self, str(torch.device(device)))

    @staticmethod
    def _rollout(generator, logP, task, batch: int, seq_len: int):
        """Markov rollouts from uniform first tokens: ``task`` an int64
        tensor of any shape picks each rollout's table of ``logP``
        (T, V, V); → (tokens, labels) int64 ``task.shape + (batch,
        seq_len)``. Every rollout steps together: ``seq_len`` sequential
        categorical draws in all."""
        V = logP.shape[-1]
        dev = logP.device
        shape = tuple(task.shape) + (batch,)
        x = torch.randint(0, V, shape, generator=generator, device=dev)
        rows = task[..., None].expand(shape)
        toks = [x]
        for _ in range(seq_len):
            u = torch.rand(shape + (V,), generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u))
            x = torch.argmax(logP[rows, x] + gumbel, dim=-1)
            toks.append(x)
        toks = torch.stack(toks, dim=-1)             # (..., B, S+1)
        return toks[..., :-1], toks[..., 1:]

    def sample(self, generator, task_id: int, batch: int, seq_len: int):
        """A Markov rollout of task ``task_id`` → (tokens, labels) int64
        (B, S) on ``generator``'s device."""
        logP = self.log_tables(generator.device)
        task = torch.full((), int(task_id), dtype=torch.int64,
                          device=generator.device)
        return self._rollout(generator, logP, task, batch, seq_len)

    def sample_traced(self, generator, task_id, batch: int, seq_len: int):
        """Like :meth:`sample` for a tensor ``task_id`` of any shape (one
        rollout batch per entry, all stepped together) → (tokens, labels)
        ``task_id.shape + (B, S)``."""
        logP = self.log_tables(generator.device)
        task = torch.as_tensor(task_id, device=logP.device).long()
        return self._rollout(generator, logP, task, batch, seq_len)


@functools.lru_cache(maxsize=16)
def _log_tables(dist: TaskTokenDistribution, device: str) -> torch.Tensor:
    P = torch.as_tensor(dist.transitions(), dtype=torch.float32,
                        device=device)
    return torch.log(P + 1e-9)


def batches(dist: TaskTokenDistribution, task_id: int, batch: int,
            seq_len: int, *, generator=None) -> Iterator:
    """Endless (tokens, labels) batches of one task from ``generator``
    (default: a CPU generator seeded 0)."""
    generator = (generator if generator is not None
                 else torch.Generator().manual_seed(0))
    while True:
        yield dist.sample(generator, task_id, batch, seq_len)


def sharded_batch(tokens, labels, mesh, data_axes=("data",)):
    """This rank's rows of (B, S) ``tokens`` and ``labels``: the batch dim
    ``Shard(0)`` over the mesh's ``data_axes``, replicated over the rest
    (every rank holds the same whole batch, so nothing is sent)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = [Shard(0) if a in data_axes else Replicate()
          for a in mesh.mesh_dim_names]
    return tuple(distribute_tensor(t, mesh, pl, src_data_rank=None).to_local()
                 for t in (tokens, labels))
