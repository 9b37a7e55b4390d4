"""xLSTM [arXiv:2405.04517]: a stack of mLSTM (matrix memory,
parallelizable) and sLSTM (scalar memory, hidden-to-hidden recurrent)
blocks. The port of the JAX package's ``models/xlstm.py``.

mLSTM cell (per head, stabilized, log-sigmoid forget):
    m_t = max(lf_t + m_{t-1}, li_t)
    C_t = e^{lf_t + m_{t-1} - m_t} C_{t-1} + e^{li_t - m_t} k_t v_t^T
    n_t = e^{lf_t + m_{t-1} - m_t} n_{t-1} + e^{li_t - m_t} k_t
    h_t = (q_t C_t) / max(|q_t · n_t|, e^{-m_t})

Train and prefill use the chunkwise form (intra-chunk quadratic +
inter-chunk state carry), held to the step-by-step recurrence
(:func:`mlstm_recurrent`, also the decode path) in the tests. The sLSTM
mixes its hidden state into its gates and is sequential: a loop over
time, the counterpart of the JAX package's ``lax.scan``. Neither has a
Pallas kernel in the JAX package; both are plain PyTorch here too (the
sLSTM's loop launches its small ops once per step and layer).

The model is one ``nn.Module`` whose ``blocks`` sit in layer order, as the
JAX package's tuple of per-layer dicts does; its flat parameter names
(``blocks.<i>.<leaf>``) are already the JAX leaf structure
(:func:`stack_params`). The caches are a list of per-layer states.

On a data x model mesh (``tp``, :mod:`repro_torch.sharding.parallel`)
the embedding and unembedding split over the vocabulary and the sLSTM
block's feed-forward ``w_ff1``/``w_ff2`` runs as a column/row region.
The mLSTM and sLSTM cells' leaves stay whole on every rank, as the table
leaves them, and run with no collective; the table also splits the
mLSTM block's ``w_up``, ``w_gate`` and ``w_down`` (by their MLP names),
which the mLSTM cell reads whole, so those three are gathered whole
before the block runs (about 3·d·pdim·4 bytes received per rank a block
and step, f32 params) and the block runs whole on every rank
(:meth:`~repro_torch.sharding.parallel.TensorParallel.materialize`).
The recurrent states are whole on every rank (the table puts them on
the batch dim only) and need no collective.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.rglru import Conv1d, conv1d_apply
from repro_torch.sharding.parallel import Region

F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def _empty_cell(B, H, hd, device):
    return (torch.zeros(B, H, hd, hd, dtype=F32, device=device),
            torch.zeros(B, H, hd, dtype=F32, device=device),
            torch.full((B, H), -math.inf, dtype=F32, device=device))


def _finite(m):
    """``where(isneginf(m), 0, m)``: an empty state's stabilizer."""
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


def mlstm_recurrent(q, k, v, li, lf, state=None):
    """Step-by-step oracle and decode path.

    q, k, v (B, H, T, hd); li, lf (B, H, T) log input/forget gates;
    state (C (B, H, hd, hd), n (B, H, hd), m (B, H)) or None.
    Returns (h (B, H, T, hd) f32, state)."""
    B, H, T, hd = q.shape
    q = q.to(F32) / math.sqrt(hd)
    k, v, li, lf = k.to(F32), v.to(F32), li.to(F32), lf.to(F32)
    C, n, m = _empty_cell(B, H, hd, q.device) if state is None else state
    hs = []
    for t in range(T):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        lf_shift = lf[:, :, t] + m
        m_new = _finite(torch.maximum(lf_shift, li[:, :, t]))
        a = torch.exp(lf_shift - m_new)                    # (B, H)
        bcoef = torch.exp(li[:, :, t] - m_new)
        C = a[..., None, None] * C + bcoef[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = a[..., None] * n + bcoef[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, C)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


def mlstm_chunked(q, k, v, li, lf, state=None, chunk: int = 256):
    """Chunkwise-parallel mLSTM; the signature of :func:`mlstm_recurrent`.
    T is padded to a multiple of ``chunk`` with steps that add nothing
    (li = -1e30) and decay nothing (lf = 0)."""
    B, H, T, hd = q.shape
    pad = -T % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, pad), value=-1e30)    # padded steps: no input
        lf = F.pad(lf, (0, pad), value=0.0)      # no decay
    nc = (T + pad) // chunk
    q = q.reshape(B, H, nc, chunk, hd).to(F32) / math.sqrt(hd)
    k = k.reshape(B, H, nc, chunk, hd).to(F32)
    v = v.reshape(B, H, nc, chunk, hd).to(F32)
    li = li.reshape(B, H, nc, chunk).to(F32)
    lf = lf.reshape(B, H, nc, chunk).to(F32)
    C, n, m = _empty_cell(B, H, hd, q.device) if state is None else state
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()

    hs = []
    for c in range(nc):                         # m may be -inf (empty)
        qc, kc, vc = q[:, :, c], k[:, :, c], v[:, :, c]
        lic, lfc = li[:, :, c], lf[:, :, c]     # (B, H, L)
        b = torch.cumsum(lfc, dim=-1)           # inclusive decay sums
        gmax = torch.cummax(lic - b, dim=-1).values
        m_inter = m[..., None] + b              # (B, H, L)
        m_t = _finite(torch.maximum(m_inter, b + gmax))

        # intra-chunk: D_ts = exp(b_t - b_s + li_s - m_t), s <= t (the
        # masked entries are exp(-inf) = 0, the reference's where(mask,
        # exp(logD), 0) without an overflowing exp in the gradient)
        logD = (b[..., :, None] - b[..., None, :] + lic[..., None, :]
                - m_t[..., :, None])
        D = torch.exp(logD.masked_fill(~causal, -math.inf))
        S = torch.einsum("bhtk,bhsk->bhts", qc, kc) * D
        num = torch.einsum("bhts,bhsv->bhtv", S, vc)
        den = torch.sum(S, dim=-1)

        # inter-chunk: the carried state's contribution
        w_inter = torch.exp(m_inter - m_t)      # exp(-inf) = 0
        w_inter = torch.where(torch.isneginf(m_inter),
                              torch.zeros_like(w_inter), w_inter)
        num = num + w_inter[..., None] * torch.einsum("bhtk,bhkv->bhtv",
                                                      qc, C)
        den = den + w_inter * torch.einsum("bhtk,bhk->bht", qc, n)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])

        # the new carry
        Bl = b[..., -1]                         # (B, H)
        cand = Bl[..., None] - b + lic          # (B, H, L)
        m_new = _finite(torch.maximum(m + Bl, cand.max(dim=-1).values))
        wc = torch.exp(m + Bl - m_new)
        wc = torch.where(torch.isneginf(m + Bl), torch.zeros_like(wc), wc)
        ws = torch.exp(cand - m_new[..., None])
        C = wc[..., None, None] * C + torch.einsum("bhs,bhsk,bhsv->bhkv",
                                                   ws, kc, vc)
        n = wc[..., None] * n + torch.einsum("bhs,bhsk->bhk", ws, kc)
        m = m_new
    h = torch.stack(hs, dim=2).reshape(B, H, nc * chunk, hd)[:, :, :T]
    return h, (C, n, m)


# ---------------------------------------------------------------------------
# sLSTM cell (sequential; hidden-to-hidden recurrence)
# ---------------------------------------------------------------------------


def slstm_apply(p, x, state=None):
    """x (B, T, d); H heads with per-head recurrent mixing R (H, hd, hd).

    state: (c, n, m, h), each (B, H, hd). Returns (y (B, T, d) in x's
    dtype, state). The four gates' recurrent products are one batched
    product a step (the reference makes four)."""
    B, T, d = x.shape
    H, hd, _ = p.r_z.shape
    # input contributions for all gates, all steps: (B, T, 4, H, hd)
    wx = torch.einsum("btd,dghk->btghk", x.to(F32), p.w.to(F32))
    if state is None:
        zeros = torch.zeros(B, H, hd, dtype=F32, device=x.device)
        c, n, h = zeros, zeros, zeros
        m = torch.full((B, H, hd), -math.inf, dtype=F32, device=x.device)
    else:
        c, n, m, h = state
    # gates z, i, f, o side by side: (H, hd, 4·hd)
    R = torch.cat([getattr(p, f"r_{g}").to(F32) for g in "zifo"], dim=-1)
    bias = p.b.to(F32)                          # (4, H, hd)
    if x.device.type == "meta" and T > 1:
        return _slstm_meta(wx, R, bias, (c, n, m, h), x.dtype)
    hs = []
    for t in range(T):
        rec = torch.einsum("bhk,hkj->bhj", h, R).unflatten(-1, (4, hd))
        pre = wx[:, t] + rec.transpose(1, 2) + bias        # (B, 4, H, hd)
        z = torch.tanh(pre[:, 0])
        li = pre[:, 1]
        lf = F.logsigmoid(pre[:, 2])
        o = torch.sigmoid(pre[:, 3])
        m_new = _finite(torch.maximum(lf + m, li))
        a = torch.exp(lf + m - m_new)
        bcf = torch.exp(li - m_new)
        c = a * c + bcf * z
        n = a * n + bcf
        h = o * c / n.clamp(min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, T, H * hd)
    return y.to(x.dtype), (c, n, m, h)


def _slstm_meta(wx, R, bias, state, dtype):
    """The sLSTM's time loop on ``meta`` tensors (the dry run,
    :mod:`repro_torch.launch.dryrun`), where only shapes exist: every step
    at once, each op over (B, T, ·) where the loop's runs T times over (B,
    ·). The recurrent product reads the input gate's contribution in place
    of the previous step's h (the same shape; values do not exist on
    meta), so the forward and backward matmul FLOPs, the elementwise
    bytes and the saved activations are the loop's, in T times fewer
    dispatches (the loop costs ~15 meta ops a step, ~0.2 ms each on a
    host CPU)."""
    B, T, _, H, hd = wx.shape
    c, n, m, _ = (t[:, None] for t in state)
    rec = torch.einsum("bthk,hkj->bthj", wx[:, :, 3], R).unflatten(
        -1, (4, hd))
    pre = wx + rec.transpose(2, 3) + bias              # (B, T, 4, H, hd)
    z = torch.tanh(pre[:, :, 0])
    li = pre[:, :, 1]
    lf = F.logsigmoid(pre[:, :, 2])
    o = torch.sigmoid(pre[:, :, 3])
    m_new = _finite(torch.maximum(lf + m, li))
    a = torch.exp(lf + m - m_new)
    bcf = torch.exp(li - m_new)
    c = a * c + bcf * z
    n = a * n + bcf
    h = o * c / n.clamp(min=1e-6)
    y = h.reshape(B, T, H * hd).clone()                # the loop's stack
    return y.to(dtype), (c[:, -1], n[:, -1], m_new[:, -1], h[:, -1])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class MLSTMBlock(nn.Module):
    """The JAX package's ``init_mlstm_block``: up/gate projections to
    pdim = proj_factor·d, a causal conv, block-diagonal q/k/v (H, phd,
    phd), input/forget gates per head (forget-open ``b_f`` = 3), the
    skip, the output norm and the down projection."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        pdim = int(cfg.xlstm.mlstm_proj_factor * d)
        phd = pdim // H
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, dtype=pd, device=device)

        def zeros(n, fill=0.0):
            return L.param(torch.full((n,), fill, dtype=pd, device=device))

        self.norm = zeros(d)
        self.w_up = L.param(L.dense_init((d, pdim), **kw))
        self.w_gate = L.param(L.dense_init((d, pdim), **kw))
        self.conv = Conv1d(pdim, cfg.xlstm.conv1d_width, pd,
                           generator=generator, device=device)
        self.w_q = L.param(L.dense_init((H, phd, phd), **kw))
        self.w_k = L.param(L.dense_init((H, phd, phd), **kw))
        self.w_v = L.param(L.dense_init((H, phd, phd), **kw))
        self.w_i = L.param(L.dense_init((pdim, H), **kw))
        self.w_f = L.param(L.dense_init((pdim, H), **kw))
        self.b_i = zeros(H)
        self.b_f = zeros(H, 3.0)                  # forget-open init
        self.skip = zeros(pdim, 1.0)
        self.out_norm = zeros(pdim)
        self.w_down = L.param(L.dense_init((pdim, d), **kw))


def mlstm_block(bp, cfg, x, state=None, tp=None, *, chunk: int = 256):
    """state: {'conv': (B, w-1, pdim), 'cell': (C, n, m)} or None.
    Returns (x + y, new state). ``tp``: the mesh's view (the block runs
    whole on every rank; module docstring)."""
    if tp is not None:
        bp, _ = tp.materialize(bp, bp._specs, {})
    dt = L.dtype_of(cfg.dtype)
    B, T, d = x.shape
    H = cfg.num_heads
    h = L.rms_norm(x, bp.norm, cfg.norm_eps)
    u = h @ bp.w_up.to(dt)                        # (B, T, pdim)
    z = h @ bp.w_gate.to(dt)
    c, new_conv = conv1d_apply(bp.conv, u,
                               None if state is None else state["conv"])
    c = F.silu(c)
    pdim = u.shape[-1]
    phd = pdim // H
    ch = c.reshape(B, T, H, phd).transpose(1, 2)  # (B, H, T, phd)
    uh = u.reshape(B, T, H, phd).transpose(1, 2)
    q = torch.einsum("bhtk,hkj->bhtj", ch, bp.w_q.to(dt))
    k = torch.einsum("bhtk,hkj->bhtj", ch, bp.w_k.to(dt))
    v = torch.einsum("bhtk,hkj->bhtj", uh, bp.w_v.to(dt))
    cf = c.to(F32)
    li = cf @ bp.w_i.to(F32) + bp.b_i.to(F32)
    lf = F.logsigmoid(cf @ bp.w_f.to(F32) + bp.b_f.to(F32))
    li, lf = li.transpose(1, 2), lf.transpose(1, 2)       # (B, H, T)
    cell_state = None if state is None else state["cell"]
    if T == 1:
        hcell, new_cell = mlstm_recurrent(q, k, v, li, lf, cell_state)
    else:
        hcell, new_cell = mlstm_chunked(q, k, v, li, lf, cell_state,
                                        chunk=min(chunk, T))
    hcell = hcell.transpose(1, 2).reshape(B, T, pdim).to(dt)
    hcell = L.rms_norm(hcell, bp.out_norm, cfg.norm_eps)
    hcell = hcell + bp.skip.to(dt) * c
    y = (hcell * F.silu(z)) @ bp.w_down.to(dt)
    return x + y, {"conv": new_conv, "cell": new_cell}


class SLSTMCell(nn.Module):
    """Input weights ``w`` (d, 4, H, hd) for the gates z, i, f, o, their
    bias ``b`` (4, H, hd) (forget gate 3), recurrent ``r_z``, ``r_i``,
    ``r_f``, ``r_o`` (H, hd, hd)."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        hd = d // H
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, dtype=pd, device=device)
        self.w = L.param(L.dense_init((d, 4, H, hd), **kw))
        b = torch.zeros(4, H, hd, dtype=F32, device=device)
        b[2] = 3.0
        self.b = L.param(b.to(pd))
        for g in "zifo":
            setattr(self, f"r_{g}", L.param(L.dense_init((H, hd, hd), **kw)))


class SLSTMBlock(nn.Module):
    """``norm``, ``conv``, ``cell``, ``mlp_norm`` and the GELU
    feed-forward ``w_ff1`` (d, proj_factor·d), ``w_ff2``."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        d = cfg.d_model
        fdim = int(cfg.xlstm.slstm_proj_factor * d)
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, dtype=pd, device=device)
        self.norm = L.param(torch.zeros(d, dtype=pd, device=device))
        self.conv = Conv1d(d, cfg.xlstm.conv1d_width, pd, generator=generator,
                           device=device)
        self.cell = SLSTMCell(cfg, generator=generator, device=device)
        self.mlp_norm = L.param(torch.zeros(d, dtype=pd, device=device))
        self.w_ff1 = L.param(L.dense_init((d, fdim), **kw))
        self.w_ff2 = L.param(L.dense_init((fdim, d), **kw))


_KEEP_FF = {"w_ff1": 1, "w_ff2": 0}


def slstm_block(bp, cfg, x, state=None, tp=None):
    """state: {'conv': (B, w-1, d), 'cell': (c, n, m, h)} or None.
    ``tp``: the mesh's view (the feed-forward region; module
    docstring)."""
    region = Region()
    if tp is not None:
        keep = (_KEEP_FF if all(bp._specs.get(k) == d
                                for k, d in _KEEP_FF.items()) else {})
        bp, left = tp.materialize(bp, bp._specs, keep)
        if "w_ff2" in left:
            region = Region(tp.group)
    dt = L.dtype_of(cfg.dtype)
    h = L.rms_norm(x, bp.norm, cfg.norm_eps)
    c, new_conv = conv1d_apply(bp.conv, h,
                               None if state is None else state["conv"])
    c = F.silu(c)
    y, new_cell = slstm_apply(bp.cell, c,
                              None if state is None else state["cell"])
    x = x + y.to(dt)
    hh = region.enter(L.rms_norm(x, bp.mlp_norm, cfg.norm_eps))
    ff = L.act_fn("gelu")(hh @ bp.w_ff1.to(dt)) @ bp.w_ff2.to(dt)
    return x + region.reduce(ff), {"conv": new_conv, "cell": new_cell}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def layer_kinds(cfg):
    s = set(cfg.xlstm.slstm_at)
    return ["slstm" if i in s else "mlstm" for i in range(cfg.num_layers)]


class XLSTM(nn.Module):
    """``embed`` (V, d), ``blocks`` in layer order (sLSTM at
    ``cfg.xlstm.slstm_at``, mLSTM elsewhere), ``final_norm``, ``unembed``
    (d, V)."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        if cfg.xlstm is None:
            raise ValueError(f"{cfg.name} has no xlstm settings")
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.embed = L.param(L.dense_init((cfg.vocab_size, cfg.d_model),
                                          dtype=pd, scale=1.0, **kw))
        self.blocks = nn.ModuleList(
            SLSTMBlock(cfg, **kw) if kind == "slstm" else MLSTMBlock(cfg, **kw)
            for kind in layer_kinds(cfg))
        self.final_norm = L.param(torch.zeros(cfg.d_model, dtype=pd,
                                              device=device))
        self.unembed = L.param(L.dense_init((cfg.d_model, cfg.vocab_size),
                                            dtype=pd, **kw))


def init(cfg, *, generator=None, device="cuda") -> XLSTM:
    """Random params drawn from ``generator`` on ``device``."""
    return XLSTM(cfg, generator=generator, device=device)


def stack_params(model: XLSTM) -> Dict[str, torch.Tensor]:
    """The module's params as a flat dict in the JAX leaf structure:
    ``blocks`` is the reference's tuple of per-layer dicts, so the names
    ``blocks.<i>.<leaf>`` stay as they are (detached); nothing is
    stacked."""
    return {name: t.detach() for name, t in model.named_parameters()}


def jax_name(model: XLSTM, name: str) -> tuple:
    """A param's JAX name and layer row: the name itself, unstacked."""
    return name, None


def param_tree(params: Dict[str, torch.Tensor], cfg,
               tp=None) -> SimpleNamespace:
    """A :func:`stack_params` dict → the tree :func:`forward` reads, with
    ``blocks`` a list of per-layer namespaces (with ``tp``, each carrying
    ``_specs``, the table's split dim of each of its leaves)."""
    tree = L.namespace(params)
    tree.blocks = [getattr(tree.blocks, str(i))
                   for i in range(cfg.num_layers)]
    if tp is not None:
        for i, bp in enumerate(tree.blocks):
            bp._specs = tp.layer_specs(f"blocks.{i}.", False)
    return tree


def init_cache(cfg, batch: int, seq_len: int, *, device="cuda"):
    """Per-layer states in layer order (``seq_len`` is not needed: the
    states do not grow). mLSTM: conv history (B, w-1, pdim) and an empty
    cell (C, n, m = -inf); sLSTM: conv history (B, w-1, d) and (c, n, m =
    -inf, h)."""
    d, H = cfg.d_model, cfg.num_heads
    pdim = int(cfg.xlstm.mlstm_proj_factor * d)
    hd = d // H
    w = cfg.xlstm.conv1d_width
    dt = L.dtype_of(cfg.dtype)
    states = []
    for kind in layer_kinds(cfg):
        if kind == "mlstm":
            states.append({
                "conv": torch.zeros(batch, w - 1, pdim, dtype=dt,
                                    device=device),
                "cell": _empty_cell(batch, H, pdim // H, device)})
        else:
            z = torch.zeros(batch, H, hd, dtype=F32, device=device)
            states.append({
                "conv": torch.zeros(batch, w - 1, d, dtype=dt, device=device),
                "cell": (z, z.clone(),
                         torch.full((batch, H, hd), -math.inf, dtype=F32,
                                    device=device), z.clone())})
    return states


def forward(params, cfg, tokens, *, positions=None, caches=None,
            cache_index: Optional[int] = None,
            embeddings: Optional[torch.Tensor] = None,
            last_only: bool = False, tp=None):
    """tokens (B, S) → (logits (B, S or 1, V) in cfg.dtype, new states or
    None, aux 0 f32). ``params``: an :class:`XLSTM` or a
    :func:`stack_params` dict. ``positions`` and ``cache_index`` are taken
    for the common signature: the states carry the position. With
    ``cfg.remat`` a forward that records gradients recomputes each block
    in the backward (``torch.utils.checkpoint``). ``tp``: on a data x
    model mesh, ``params`` is this rank's shards of a
    :func:`stack_params` dict (module docstring)."""
    if isinstance(params, dict):
        params = param_tree(params, cfg, tp)
    dt = L.dtype_of(cfg.dtype)
    if embeddings is not None:
        x = embeddings.to(dt)
    elif tp is not None:
        x = tp.embed(params.embed, tokens).to(dt)
    else:
        x = params.embed[tokens].to(dt)
    remat = cfg.remat and torch.is_grad_enabled()
    new_states = []
    for i, kind in enumerate(layer_kinds(cfg)):
        fn = slstm_block if kind == "slstm" else mlstm_block
        st = None if caches is None else caches[i]
        if remat:
            x, ns = checkpoint(fn, params.blocks[i], cfg, x, st, tp,
                               use_reentrant=False)
        else:
            x, ns = fn(params.blocks[i], cfg, x, st, tp)
        new_states.append(ns)
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    w_out = params.unembed.to(dt)
    logits = x @ w_out if tp is None else tp.unembed(x, w_out, False)
    return (logits, None if caches is None else new_states,
            torch.zeros((), dtype=F32, device=x.device))


def _read_in_f32(name: str) -> bool:
    """The forward reads the RMS norms, the mLSTM's gate weights and
    biases (``w_i``, ``w_f``, ``b_i``, ``b_f``) and the whole sLSTM cell in
    f32; every other parameter only through a cast to ``cfg.dtype``."""
    leaf = name.rsplit(".", 1)[-1]
    return (leaf.endswith("norm") or leaf in ("w_i", "w_f", "b_i", "b_f")
            or ".cell." in name)


def cast_for_serving(model: XLSTM, cfg) -> XLSTM:
    """Cast, once, every parameter the forward reads only through a cast
    to ``cfg.dtype``, replacing each tensor in place. The numbers are
    unchanged."""
    dt = L.dtype_of(cfg.dtype)
    for name, p in model.named_parameters():
        if not _read_in_f32(name):
            p.data = p.data.to(dt)
    return model
