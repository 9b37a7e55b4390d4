"""Step builders: the port's ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` (the JAX package's ``launch/steps.py``), and on
a data x model ``DeviceMesh`` the placements of a step's params, Adam
state, caches and batch (:func:`shardings_for`); every step also runs
every LM family tensor- and data-parallel on such a mesh.
:func:`lower_step` builds a step and its ``meta`` inputs at one rank's
shapes for the dry run (:mod:`repro_torch.launch.dryrun`). The serving
steps run without autograd.
"""
from __future__ import annotations

import torch

from repro_torch.models.api import get_model, lm_loss
from repro_torch.optim import adam, clip_scale
from repro_torch.sharding import rules
from repro_torch.sharding.parallel import sum_over_data


def value_and_grad(loss, params, *args):
    """(loss, {name: gradient}) of ``loss(params, *args)`` at a
    ``{name: tensor}`` dict, by ``torch.autograd`` (so a ``cfg.remat``
    forward recomputes its blocks in the backward)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        val = loss(leaves, *args)
        grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads))


def make_train_step(cfg, *, lr: float = 3e-4, clip_norm: float = 1.0,
                    mesh=None, specs=None, in_place: bool = False):
    """(params, opt_state, batch{tokens, labels, frames (encdec)}) ->
    (params, opt_state, {"loss", "grad_norm"}): Adam on the gradient
    clipped to a global norm of ``clip_norm``. ``params`` is the model's
    ``stack_params`` dict. Returns ``(train_step, opt)``.

    The step consumes ``params`` and ``opt_state`` through the
    optimizer's ``apply`` (:mod:`repro_torch.optim.optimizers`), so its
    peak is about the f32 params, Adam's two moments and the gradient (4×
    the params), not old and new of each (8×). The numbers are those of
    clipping the whole gradient and updating every leaf at once. With
    ``in_place`` the new params and state are written into the given
    tensors (the same bits): a captured step's donated buffers.

    On a data x model ``mesh`` (every LM family) ``params`` are
    this rank's shards (``specs``: the table's,
    :func:`repro_torch.sharding.parallel.shard_params`) and the batch its
    rows, and the loss and the norm are the whole batch's and model's: the
    gradient of :func:`lm_loss` is summed over the data axes, its norm
    sums the split leaves' squares over the model group, and Adam updates
    each shard (elementwise, so each shard's numbers are the whole
    leaf's)."""
    model = get_model(cfg)
    opt = adam(lr)
    tp = _view(mesh, specs)

    def loss(params, batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       embeddings=batch.get("frames"), model=model, tp=tp)

    def train_step(params, opt_state, batch):
        l, g = value_and_grad(loss, params, batch)
        if tp is not None and tp.dp > 1:
            l = sum_over_data(l.clone(), mesh)
            for x in g.values():
                sum_over_data(x, mesh)
        scale, gnorm = clip_scale(
            g, clip_norm, norm=None if tp is None else tp.grad_norm(g))
        params, opt_state = opt.apply(g, opt_state, params, scale,
                                      in_place=in_place)
        return params, opt_state, {"loss": l, "grad_norm": gnorm}

    return train_step, opt


def _view(mesh, specs):
    """The :class:`~repro_torch.sharding.parallel.TensorParallel` view of
    ``mesh`` (None without one)."""
    if mesh is None:
        return None
    from repro_torch.sharding.parallel import TensorParallel
    return TensorParallel(mesh, specs)


def make_prefill_step(cfg, *, mesh=None, specs=None):
    """(params, caches, batch{tokens, frames (encdec)}) -> (last-position
    logits (B, 1, V), caches). Only the last position is unembedded, which
    gives the numbers of slicing the full logits without the (B, S, V)
    tensor. The encoder-decoder's ``frames`` run its encoder and fill the
    cross caches. On a data x model ``mesh``, ``params`` and ``caches``
    are this rank's shards by the table (``specs``) and the batch its
    rows."""
    model = get_model(cfg)
    tp = _view(mesh, specs)

    @torch.no_grad()
    def prefill_step(params, caches, batch):
        frames = batch.get("frames")
        kw = {} if frames is None else {"embeddings": frames}
        if tp is not None:
            kw["tp"] = tp
        logits, caches, _ = model.forward(params, cfg, batch["tokens"],
                                          caches=caches, cache_index=0,
                                          last_only=True, **kw)
        return logits, caches

    return prefill_step


def make_decode_step(cfg, *, mesh=None, specs=None):
    """(params, caches, batch{tokens (B, 1), cache_index}) -> (greedy next
    token (B, 1) int32, caches); on a ``mesh`` as
    :func:`make_prefill_step`. ``cache_index`` is a 0-d int32 tensor on
    the device, as the reference's ``jnp.int32(prompt_len + i)`` (read
    there, so one captured step serves every position), or a Python
    int (the same bits)."""
    model = get_model(cfg)
    tp = _view(mesh, specs)

    @torch.no_grad()
    def decode_step(params, caches, batch):
        kw = {} if tp is None else {"tp": tp}
        logits, caches, _ = model.forward(params, cfg, batch["tokens"],
                                          caches=caches,
                                          cache_index=batch["cache_index"],
                                          **kw)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], caches

    return decode_step


# ---------------------------------------------------------------------------
# shapes and placements on a mesh
# ---------------------------------------------------------------------------


def input_specs(cfg, shape) -> dict:
    """Every model input of this (arch, :class:`repro_torch.configs.
    InputShape`) as a ``meta`` tensor (shape and dtype, no storage)."""
    B, S = shape.global_batch, shape.seq_len

    def tok(b, s):
        return torch.empty((b, s), dtype=torch.int32, device="meta")

    out = {}
    if shape.mode == "train":
        out["tokens"], out["labels"] = tok(B, S), tok(B, S)
    elif shape.mode == "prefill":
        out["tokens"] = tok(B, S)
    else:
        out["tokens"] = tok(B, 1)
        out["cache_index"] = torch.empty((), dtype=torch.int32,
                                         device="meta")
    if cfg.family == "encdec" and shape.mode != "decode":
        # decode reads the cross K/V the prefill cached
        out["frames"] = torch.empty(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device="meta")
    return out


def abstract_params(cfg) -> dict:
    """The ``stack_params`` dict of ``cfg`` on ``meta`` (no storage)."""
    model = get_model(cfg)
    return model.stack_params(model.init(cfg, device="meta"))


def abstract_caches(cfg, shape):
    return get_model(cfg).init_cache(cfg, shape.global_batch, shape.seq_len,
                                     device="meta")


def shardings_for(cfg, mesh, shape, *, with_opt: bool):
    """(params, Adam state, caches, batch) DTensor placements on ``mesh``
    for one (arch, input shape): params by the table, Adam's moments
    mirroring them and its step replicated, caches (None in training) and
    the batch over the data axes."""
    from torch.distributed.tensor import Replicate

    p_abs = abstract_params(cfg)
    p_pl = rules.param_placements(p_abs, cfg, mesh)
    o_pl = None
    if with_opt:
        o_pl = {"step": [Replicate()] * mesh.ndim, "mu": dict(p_pl),
                "nu": dict(p_pl)}
    c_pl = None
    if shape.mode != "train":
        c_pl = rules.cache_placements(abstract_caches(cfg, shape), mesh)
    # the 0-d cache_index has no batch dim, so the table replicates it
    b_pl = rules.data_placements(input_specs(cfg, shape), mesh)
    return p_pl, o_pl, c_pl, b_pl


def _meta_local(t, spec, mesh):
    from repro_torch.sharding.parallel import local_shape

    return torch.empty(local_shape(tuple(t.shape), spec, mesh),
                       dtype=t.dtype, device="meta")


def lower_step(cfg, mesh, shape, *, lr: float = 3e-4):
    """(step, inputs) of the right step for (cfg, :class:`repro_torch.
    configs.InputShape`) on a data x model ``mesh``, for the dry run: the
    train step with Adam (``shape.mode == "train"``), the prefill, or the
    decode step, built for the mesh, and its inputs as ``meta`` tensors at
    this rank's shapes (params by the table, Adam's state mirroring them,
    caches by the table, the batch over the data axes). ``step(*inputs)``
    runs it. The decode position (``cache_index``) is ``seq_len − 1``, a
    Python int (a ``meta`` tensor has no value to compute positions
    from).
    The JAX package's ``lower_step`` returns a lowered XLA program; eager
    PyTorch runs the step instead (:mod:`repro_torch.launch.dryrun`)."""
    p_abs = abstract_params(cfg)
    specs = rules.param_specs(p_abs, cfg, mesh)
    params = {k: _meta_local(v, specs[k], mesh) for k, v in p_abs.items()}
    batch = {k: _meta_local(v, rules.data_spec(tuple(v.shape), mesh), mesh)
             for k, v in input_specs(cfg, shape).items()
             if k != "cache_index"}
    if shape.mode == "train":
        step, opt = make_train_step(cfg, lr=lr, mesh=mesh, specs=specs)
        return step, (params, opt.init(params), batch)
    caches = rules._map_tree(
        lambda names, t: _meta_local(
            t, rules.cache_spec(names, tuple(t.shape), mesh), mesh),
        abstract_caches(cfg, shape))
    if shape.mode == "prefill":
        return make_prefill_step(cfg, mesh=mesh, specs=specs), (
            params, caches, batch)
    batch["cache_index"] = shape.seq_len - 1
    return make_decode_step(cfg, mesh=mesh, specs=specs), (
        params, caches, batch)
