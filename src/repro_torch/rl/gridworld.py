"""The paper's robotized environment (Sect. IV): crawling robots on an 8×5
grid of 40 landmark points, 4 actions (F, B, L, R), and M = 6 trajectory
tasks given by position-reward lookup tables. Tables are numpy (exactly
the JAX package's); episodes run on tensors on the caller's device."""
from __future__ import annotations

import functools

import numpy as np
import torch

GRID_W, GRID_H = 8, 5           # 40 landmark points
NUM_CELLS = GRID_W * GRID_H
NUM_ACTIONS = 4                 # F(+x), B(-x), L(+y), R(-y)
ENTRY = (0, 2)                  # common entry point (left edge, mid row)
NUM_TASKS = 6

# action -> (dx, dy)
MOVES = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.int32)


def _trajectories():
    """Six max-reward trajectories: common entry + prefix, diverging
    exits (Fig. 2(b))."""
    prefix = [(x, 2) for x in range(0, 3)]
    exits = [
        [(3, 2), (4, 2), (5, 2), (6, 2), (7, 2)],                  # straight
        [(3, 3), (4, 3), (5, 4), (6, 4), (7, 4)],                  # up-right
        [(3, 1), (4, 1), (5, 0), (6, 0), (7, 0)],                  # down-right
        [(3, 3), (3, 4), (4, 4), (5, 4), (5, 3)],                  # up hook
        [(3, 1), (3, 0), (4, 0), (5, 0), (5, 1)],                  # down hook
        [(3, 2), (4, 2), (4, 3), (5, 3), (6, 3), (7, 3)],          # late up
    ]
    return [prefix + e for e in exits]


TRAJECTORIES = _trajectories()


def reward_table(task_id: int) -> np.ndarray:
    """Position-reward lookup (Sect. IV-A): larger reward near the task's
    trajectory, graded by grid distance and progress along the path;
    off-trajectory cells penalize."""
    tr = TRAJECTORIES[task_id]
    R = np.full((GRID_W, GRID_H), -0.5, np.float32)
    for x in range(GRID_W):
        for y in range(GRID_H):
            d, i_near = min(
                (abs(x - tx) + abs(y - ty), i)
                for i, (tx, ty) in enumerate(tr))
            prog = i_near / max(len(tr) - 1, 1)
            if d == 0:
                R[x, y] = 5.0 + 5.0 * prog
            elif d == 1:
                R[x, y] = 1.0
            elif d == 2:
                R[x, y] = 0.0
    return R


REWARD_TABLES = np.stack([reward_table(i) for i in range(NUM_TASKS)])


@functools.lru_cache(maxsize=None)
def _device_tables(device: str):
    """The reward tables, the moves and the entry point on ``device``,
    copied from the host once: a captured round copies nothing from the
    host."""
    return (torch.as_tensor(REWARD_TABLES, device=device),
            torch.as_tensor(MOVES, dtype=torch.int64, device=device),
            torch.tensor(ENTRY, device=device))


def cell_index(pos):
    return pos[..., 0] * GRID_H + pos[..., 1]


def one_hot_state(pos):
    """(..., 2) int → (..., 40) float32 one-hot — the DQN observation."""
    return torch.nn.functional.one_hot(cell_index(pos).long(),
                                       NUM_CELLS).to(torch.float32)


def step(pos, action, task_id: int):
    """pos (..., 2) int, action (...,) int → (new_pos, reward)."""
    tables, moves, _ = _device_tables(str(pos.device))
    new = pos.long() + moves[action.long()]
    new = torch.stack([new[..., 0].clamp(0, GRID_W - 1),
                       new[..., 1].clamp(0, GRID_H - 1)], dim=-1)
    return new, tables[task_id, new[..., 0], new[..., 1]]


def rollout(generator, qnet_fn, task_id: int, *, steps: int = 20,
            epsilon: float = 0.1, batch: int = 1, device="cuda"):
    """ε-greedy episode(s) from the common entry point.

    qnet_fn: state (B, 40) → q-values (B, 4). Returns a dict of
    (B, steps, ...) tensors: state, action, reward, next_state."""
    entry = _device_tables(str(torch.device(device)))[2]
    pos = entry.expand(batch, 2).long()
    out = {"state": [], "action": [], "reward": [], "next_state": []}
    for _ in range(steps):
        s = one_hot_state(pos)
        greedy = torch.argmax(qnet_fn(s), dim=-1)
        rand = torch.randint(0, NUM_ACTIONS, (batch,), generator=generator,
                             device=device)
        explore = torch.rand(batch, generator=generator,
                             device=device) < epsilon
        a = torch.where(explore, rand, greedy)
        pos, r = step(pos, a, task_id)
        for name, v in zip(out, (s, a, r, one_hot_state(pos))):
            out[name].append(v)
    return {name: torch.stack(v, dim=1) for name, v in out.items()}


def running_reward(rewards, nu: float = 0.99):
    """The paper's accuracy indicator R = Σ_h ν^h r_h (per episode)."""
    H = rewards.shape[-1]
    disc = nu ** torch.arange(H, dtype=torch.float32, device=rewards.device)
    return (rewards * disc).sum(dim=-1)


def greedy_running_reward(generator, qnet_fn, task_id: int, *,
                          steps: int = 20, episodes: int = 4,
                          nu: float = 0.99, device="cuda"):
    """Mean running reward of greedy (ε = 0) episodes."""
    data = rollout(generator, qnet_fn, task_id, steps=steps, epsilon=0.0,
                   batch=episodes, device=device)
    return running_reward(data["reward"], nu).mean()
