"""Deep Q-Learning with double learning (paper Sect. II-C, Eq. 7):

    ℓ(x | W) = [ r + ν max_y q̃(x', y) − q(x, y | W) ]²

with ν = 0.99 and q̃ a target network (the online net picks the argmax
action, the target net evaluates it).
"""
from __future__ import annotations

from repro_torch.models import dqn as qmodel
from repro_torch.rl import gridworld as gw

NU = 0.99
R_SCALE = 0.1     # TD-target reward scaling (argmax-invariant)


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


def evaluate(generator, params, cfg, task_id: int, *, episodes: int = 4,
             steps: int = 20):
    """Mean greedy running reward R (the paper's accuracy target), on
    the params' device."""
    return gw.greedy_running_reward(
        generator, lambda s: qmodel.forward(params, cfg, s), task_id,
        steps=steps, episodes=episodes,
        device=next(iter(params.values())).device)
