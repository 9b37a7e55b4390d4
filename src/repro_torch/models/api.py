"""Family dispatch and the loss: the port's counterpart of the JAX
package's ``models/api.py``.

Every family exposes ``init(cfg, *, generator, device)`` and
``forward(params, cfg, tokens, ...) -> (logits, caches, aux)``; decoder
families also ``init_cache(cfg, batch, seq_len, *, device)`` and
``cast_for_serving(params, cfg)``, ``stack_params(module)`` (the JAX
leaf structure training reads) and ``jax_name(module, name)`` (a param's
leaf in that structure and its row on the leaf's layer axis: the one
rule ``stack_params`` and :mod:`repro_torch.convert` both read).
``dense``, ``moe`` and ``vlm`` are the transformer, ``hybrid``
RecurrentGemma, ``ssm`` xLSTM, ``encdec`` whisper, ``dqn`` the case
study's Q-network: every family the JAX package's ``get_model``
resolves.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.sharding.parallel import sum_over_data


def get_model(cfg) -> SimpleNamespace:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as m
    elif fam == "hybrid":
        from repro_torch.models import rglru as m
    elif fam == "ssm":
        from repro_torch.models import xlstm as m
    elif fam == "encdec":
        from repro_torch.models import encdec as m
    elif fam == "dqn":
        from repro_torch.models import dqn as m
        return SimpleNamespace(init=m.init, forward=m.forward,
                               init_cache=None)
    else:
        raise ValueError(f"unknown family {fam!r} ({cfg.name})")
    return SimpleNamespace(init=m.init, forward=m.forward,
                           init_cache=m.init_cache,
                           cast_for_serving=m.cast_for_serving,
                           stack_params=m.stack_params,
                           jax_name=m.jax_name)


def lm_loss(params, cfg, tokens, labels, *, embeddings=None, model=None,
            tp=None):
    """Next-token cross-entropy in f32, the mean over valid labels (>= 0),
    plus the MoE aux loss. ``params``: the model's module, or its
    ``stack_params`` dict. ``embeddings``: the encoder-decoder's frames.
    Differentiable in both; the attention kernel's gradient is its plain
    version's (:mod:`repro_torch.kernels.ops`).

    ``tp``: any LM family on a data x model mesh
    (:class:`repro_torch.sharding.parallel.TensorParallel`), ``params``
    this rank's shards and ``tokens``/``labels`` its rows of a batch that
    divides the data-parallel size (:func:`repro_torch.data.pipeline.
    sharded_batch`). The loss is then this rank's term: its rows' summed
    NLL over the whole batch's valid labels, plus the data-averaged aux
    over the data-parallel size, so the terms summed over the data axes
    are the whole batch's loss with a per-shard MoE."""
    model = model or get_model(cfg)
    kw = {} if embeddings is None else {"embeddings": embeddings}
    if tp is not None:
        kw["tp"] = tp
    logits, _, aux = model.forward(params, cfg, tokens, **kw)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    valid = labels >= 0
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    n_valid = valid.sum()
    if tp is not None and tp.dp > 1:
        n_valid = sum_over_data(n_valid.clone(), tp.mesh)
        aux = aux / tp.dp
    loss = torch.sum(nll * valid) / n_valid.clamp(min=1)
    return loss + aux


def count_params(params) -> int:
    """Elements in every parameter of a model (an ``nn.Module``)."""
    return sum(t.numel() for t in params.parameters())
