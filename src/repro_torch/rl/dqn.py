"""Deep Q-Learning with double learning (paper Sect. II-C, Eq. 7):

    ℓ(x | W) = [ r + ν max_y q̃(x', y) − q(x, y | W) ]²

with ν = 0.99 and q̃ a target network (the online net picks the argmax
action, the target net evaluates it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import dqn as qmodel
from repro_torch.rl import gridworld as gw

NU = 0.99
R_SCALE = 0.1     # TD-target reward scaling (argmax-invariant)


class DQNState(NamedTuple):
    params: dict
    target_params: dict


def init(generator, cfg, *, device="cuda") -> DQNState:
    """A Q-network drawn from ``generator`` and its target network, a
    copy of it."""
    p = qmodel.init(cfg, generator=generator, device=device)
    return DQNState(params=p,
                    target_params={k: v.clone() for k, v in p.items()})


def td_loss(params, cfg, batch, target_params=None):
    """Double-DQN TD loss on a batch of transitions: ``batch`` holds
    state (B, 40), action (B,), reward (B,), next_state (B, 40). The
    target net is ``target_params``, else ``batch["target_params"]``,
    else ``params``."""
    tp = target_params if target_params is not None else \
        batch.get("target_params", params)
    q = qmodel.forward(params, cfg, batch["state"])
    q_sa = q.gather(1, batch["action"].long()[:, None])[:, 0]
    q_next_online = qmodel.forward(params, cfg, batch["next_state"])
    a_star = q_next_online.argmax(dim=-1)
    q_next_t = qmodel.forward(tp, cfg, batch["next_state"])
    q_next = q_next_t.gather(1, a_star[:, None])[:, 0]
    target = batch["reward"] * R_SCALE + NU * q_next.detach()
    return (target - q_sa).square().mean()


def make_loss_fn(cfg):
    """loss_fn(params, batch), the target network frozen in the batch."""

    def loss_fn(params, batch):
        return td_loss(params, cfg, batch,
                       target_params=batch.get("target_params"))

    return loss_fn


def collect_experience(generator, params, cfg, task_id: int, *,
                       steps: int = 20, epsilon: float = 0.1,
                       batch: int = 2):
    """ε-greedy experience with the CURRENT Q-network, the paper's E_ik
    (``batch`` episodes of ``steps`` consecutive motions), flattened to
    (batch · steps, ...) transitions, episode-major."""
    data = gw.rollout(generator, lambda s: qmodel.forward(params, cfg, s),
                      task_id, steps=steps, epsilon=epsilon, batch=batch,
                      device=next(iter(params.values())).device)
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in data.items()}


def experience_batches(generator, params, cfg, task_id: int,
                       n_batches: int, *, batch_size: int = 32,
                       epsilon: float = 0.1, target_params=None):
    """``n_batches`` TD mini-batches of ``batch_size`` transitions
    resampled from fresh ε-greedy experience, stacked on a leading batch
    axis; ``target_params``, when given, broadcast along it."""
    episodes = max(batch_size * n_batches // 20, 2)
    data = collect_experience(generator, params, cfg, task_id,
                              batch=episodes, epsilon=epsilon)
    N = data["state"].shape[0]
    idx = torch.randint(0, N, (n_batches, batch_size), generator=generator,
                        device=data["state"].device)
    out = {k: v[idx] for k, v in data.items()}
    if target_params is not None:
        out["target_params"] = {
            k: v[None].expand((n_batches,) + tuple(v.shape))
            for k, v in target_params.items()}
    return out


def evaluate(generator, params, cfg, task_id: int, *, episodes: int = 4,
             steps: int = 20):
    """Mean greedy running reward R (the paper's accuracy target), on
    the params' device."""
    return gw.greedy_running_reward(
        generator, lambda s: qmodel.forward(params, cfg, s), task_id,
        steps=steps, episodes=episodes,
        device=next(iter(params.values())).device)
