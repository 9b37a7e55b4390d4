"""Decentralized federated learning by average consensus — paper Eq. (6).

    W^{(k)}_{t+1} = W^{(k)}_t + Σ_{h∈N_k} σ_{k,h} (W^{(h)}_t − W^{(k)}_t),
    σ_{k,h} = |E_h| / Σ_{j∈N_k} |E_j|

Numpy helpers build the σ matrix and the sparse neighbour tables; the
step functions mix agent-stacked params (a dict of (K, ...) tensors):

* ``impl="dense"``  — one (K, K) matmul per leaf (the reference);
* ``impl="sparse"`` — one launch per leaf of the population-level
  consensus kernels in :mod:`repro_torch.kernels.ops`, gathering each
  agent's H neighbour rows straight from the (K, N) stack; int wires
  stay int8 lanes into the fused dequantizing kernel;
* ``impl="auto"``   — :func:`auto_path` picks one of the two.

Pick through :class:`repro_torch.core.engine.ConsensusEngine` rather than
calling these directly.
"""
from __future__ import annotations

import difflib

import numpy as np
import torch

# ---------------------------------------------------------------------------
# mixing matrices (numpy, float32 — the JAX package's values exactly)
# ---------------------------------------------------------------------------


def ring_adjacency(K: int, hops: int = 1) -> np.ndarray:
    """Symmetric ring: each agent sees ``hops`` neighbours each side."""
    A = np.zeros((K, K), bool)
    for k in range(K):
        for d in range(1, hops + 1):
            A[k, (k + d) % K] = True
            A[k, (k - d) % K] = True
    if K > 1:
        np.fill_diagonal(A, False)
    return A


def full_adjacency(K: int) -> np.ndarray:
    A = np.ones((K, K), bool)
    np.fill_diagonal(A, False)
    return A


MIX_KINDS = ("paper", "metropolis")


def _unknown_kind_msg(kind) -> str:
    """Refusal text for a bad mixing kind, naming the nearest match."""
    close = difflib.get_close_matches(str(kind), MIX_KINDS, n=1)
    hint = f"; did you mean {close[0]!r}?" if close else ""
    return (f"unknown mixing kind {kind!r}: supported kinds are "
            f"'paper' (Eq.-(6) data-size weights) and 'metropolis' "
            f"(doubly stochastic){hint}")


def mixing_weights(data_sizes, adjacency, kind: str = "paper",
                   include_self: bool = True) -> np.ndarray:
    """(K, K) float32 row-stochastic σ with Σ[k, h] = σ_{k,h}.

    kind="paper": σ_{k,h} = |E_h| / Σ_j |E_j| over N_k (∪ {k} with
    ``include_self``, the default; the literal reading has zero self
    weight). kind="metropolis": σ_{k,h} = 1 / (1 + max(deg_k, deg_h)),
    self weight 1 − Σ. ``adjacency`` is bool (lockstep) or float per-edge
    weights in [0, 1].
    """
    sizes = np.asarray(data_sizes, np.float32)
    A = np.asarray(adjacency)
    one = np.float32(1.0)
    if np.issubdtype(A.dtype, np.floating):
        A = A.astype(np.float32)
        if kind == "paper":
            w = A * sizes[None, :]
        elif kind == "metropolis":
            deg = A.sum(axis=1)
            w = A * (one / (one + np.maximum(deg[:, None], deg[None, :])))
            return w + np.diag(one - w.sum(axis=1))
        else:
            raise ValueError(_unknown_kind_msg(kind))
    else:
        A = A.astype(bool)
        if kind == "paper":
            w = np.where(A, sizes[None, :], np.float32(0.0))
        elif kind == "metropolis":
            deg = A.sum(axis=1).astype(np.float32)
            w = np.where(A, one / (one + np.maximum(deg[:, None], deg[None, :])),
                         np.float32(0.0))
            return w + np.diag(one - w.sum(axis=1))
        else:
            raise ValueError(_unknown_kind_msg(kind))
    denom = w.sum(axis=1, keepdims=True)
    if include_self:
        denom = denom + sizes[:, None]
    denom = np.maximum(denom, np.float32(1e-12))
    return w / denom


def mixing_weights_torch(sizes, adjacency, kind: str = "paper",
                         include_self: bool = True) -> torch.Tensor:
    """:func:`mixing_weights` in torch ops on the adjacency's device, for
    σ rebuilt each round from a surviving graph: ``sizes`` (K,) f32,
    ``adjacency`` (K, K) bool or float per-edge weights in [0, 1] (a
    {0, 1}-valued float input gives the bool path's bits)."""
    A = adjacency
    zero = torch.zeros((), dtype=torch.float32, device=A.device)
    if A.is_floating_point():
        A = A.to(torch.float32)
        if kind == "paper":
            w = A * sizes[None, :]
        elif kind == "metropolis":
            deg = A.sum(dim=1)
            w = A * (1.0 / (1.0 + torch.maximum(deg[:, None], deg[None, :])))
            return w + torch.diag(1.0 - w.sum(dim=1))
        else:
            raise ValueError(_unknown_kind_msg(kind))
    else:
        if kind == "paper":
            w = torch.where(A, sizes[None, :], zero)
        elif kind == "metropolis":
            deg = A.sum(dim=1, dtype=torch.float32)
            w = torch.where(A, 1.0 / (1.0 + torch.maximum(deg[:, None],
                                                          deg[None, :])),
                            zero)
            return w + torch.diag(1.0 - w.sum(dim=1))
        else:
            raise ValueError(_unknown_kind_msg(kind))
    denom = w.sum(dim=1, keepdim=True)
    if include_self:
        denom = denom + sizes[:, None]
    return w / torch.clamp_min(denom, 1e-12)


def _effective_mix(mix):
    """Add the implicit self weight so rows sum to 1 exactly (numpy, or
    a tensor for a σ rebuilt on the card)."""
    if isinstance(mix, torch.Tensor):
        return mix + torch.diag(1.0 - mix.sum(dim=1))
    mix = np.asarray(mix, np.float32)
    return mix + np.diag(np.float32(1.0) - mix.sum(axis=1))


def resolve_mix(mix, data_sizes=None, kind: str = "paper",
                include_self: bool = True):
    """Accept either a ready (K, K) σ matrix or a Topology object."""
    if hasattr(mix, "mixing"):
        return mix.mixing(data_sizes, kind=kind, include_self=include_self)
    return mix


#: K · max-degree floor below which ``auto`` keeps the dense (K, K)
#: matmul. The value (512) is a CPU calibration carried over from the JAX
#: package's ``BENCH_consensus_scale.json`` rows (per-agent gather
#: dispatch overhead against one small matmul, on a CPU). It has not been
#: measured on the card, where the population kernels launch once per
#: leaf; it is to be re-measured there (ROADMAP A11).
SPARSE_GATHER_FLOOR = 512


def auto_path(mix, codec=None) -> str:
    """``"sparse"`` while the graph is sparse enough for the gather to
    beat the dense matmul, else ``"dense"``.

    Below :data:`SPARSE_GATHER_FLOOR` total gather work (K · max degree)
    the population stays dense. With an int ``codec`` the gathered payload
    is int8 lanes (plus block scales), so the degree is discounted by the
    wire's bytes per parameter before the max-degree > K/4 test; every
    other codec decodes to f32 before the gather and counts at full width.
    """
    M = np.asarray(mix)
    K = M.shape[0]
    off = M.copy()
    np.fill_diagonal(off, 0.0)
    H = int((off != 0).sum(axis=1).max()) if K else 0
    if K * max(float(H), 1.0) < SPARSE_GATHER_FLOOR:
        return "dense"
    codec = getattr(codec, "inner", codec)       # unwrap ErrorFeedback
    qblock = getattr(codec, "block", None)
    gathers_wire = getattr(codec, "qbits", None) is not None
    wire_bits = (8.0 + (32.0 / qblock if qblock else 0.0)
                 if gathers_wire else None)
    h_eff = H * (wire_bits / 32.0) if wire_bits else float(H)
    return "sparse" if h_eff <= max(K // 4, 1) else "dense"


def sparse_structure(mix):
    """(idx, sig) from a concrete mix: idx (K, H) int32 neighbour indices,
    sig (K, H) float32 σ, H = max degree. Short rows are padded with the
    agent's own index and σ = 0 (an exact no-op in Eq. 6); diagonal self
    weights are dropped (the update form x + Σ σ(nb − x) carries them)."""
    M = np.asarray(mix, np.float32)
    K = M.shape[0]
    off = M.copy()
    np.fill_diagonal(off, 0.0)
    H = max(int((off != 0).sum(axis=1).max()), 1)
    idx = np.tile(np.arange(K, dtype=np.int32)[:, None], (1, H))
    sig = np.zeros((K, H), np.float32)
    for k in range(K):
        nbr = np.flatnonzero(off[k])
        idx[k, :len(nbr)] = nbr
        sig[k, :len(nbr)] = off[k, nbr]
    return idx, sig


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


def _device_of(stacked_params) -> torch.device:
    return next(iter(stacked_params.values())).device


def _structure(mix, structure, device):
    if structure is None:
        structure = sparse_structure(mix)
    idx, sig = structure
    return (torch.as_tensor(idx, dtype=torch.int32, device=device),
            torch.as_tensor(sig, dtype=torch.float32, device=device))


def consensus_step(stacked_params, mix, *, impl: str = "dense",
                   codec=None, codec_state=None, generator=None,
                   error_feedback: bool = True, gamma: float = 1.0,
                   structure=None):
    """Eq. (6) on agent-stacked params (a dict of (K, ...) tensors).
    ``mix``: (K, K) σ or a Topology (uniform paper weights).

    ``codec`` compresses the exchanged models: every agent consumes its
    neighbours' DECODED models x̂_h and recentres on its own decoded copy,
    W_k + Σ_h σ_{k,h}(x̂_h − x̂_k), which keeps the population mean exact
    under doubly-stochastic σ (CHOCO). Lossy codecs get error feedback
    unless ``error_feedback=False``; ``codec_state`` is the stacked
    residual dict (None ⇒ zeros), ``generator`` enables stochastic
    rounding, ``gamma`` damps the off-diagonal σ. With a codec the result
    is ``(params, codec_state)``, without it the params.

    ``structure``: a ready ``(idx, sig)`` pair in :func:`sparse_structure`
    layout (numpy or tensors on the params' device) for the sparse path,
    e.g. a round's σ renormalised on its surviving lanes (any H; σ = 0
    lanes are exact no-ops). On the dense path ``mix`` may be a (K, K)
    tensor, a round's σ rebuilt on the card.
    """
    mix = resolve_mix(mix)
    if impl not in ("dense", "sparse", "auto"):
        raise ValueError(f"unknown impl {impl!r}; use dense/sparse/auto")
    if codec is None and (codec_state is not None or gamma != 1.0):
        raise ValueError(
            f"codec_state={'set' if codec_state is not None else None} "
            f"/ gamma={gamma} only apply to compressed consensus but "
            "codec=None — pass codec= (e.g. 'int8'), or drop them")
    if codec is not None:
        from repro_torch.comms import codecs
        codec = codecs.resolve_codec(codec, error_feedback)
        return _compressed_consensus_step(
            stacked_params, mix, codec, codec_state, generator, impl=impl,
            gamma=gamma, structure=structure)
    if impl == "auto":
        impl = auto_path(mix)
    device = _device_of(stacked_params)
    out = {}
    if impl == "dense":
        M = torch.as_tensor(_effective_mix(mix), device=device)
        for name, x in stacked_params.items():
            xf = x.to(torch.float32).reshape(x.shape[0], -1)
            out[name] = (M @ xf).reshape(x.shape).to(x.dtype)
        return out

    from repro_torch.kernels import ops
    idx, sig = _structure(mix, structure, device)
    for name, x in stacked_params.items():
        xf = x.to(torch.float32).reshape(x.shape[0], -1)
        y = ops.consensus_update_pop(xf, idx, sig)
        out[name] = y.reshape(x.shape).to(x.dtype)
    return out


def _compressed_consensus_step(stacked_params, mix, codec, codec_state,
                               generator, *, impl: str, gamma: float = 1.0,
                               structure=None):
    """Eq. (6) over codec'd exchanges (see :func:`consensus_step`).

    Per leaf: each agent encodes m_k = W_k + r_k and decodes x̂_k; the
    update mixes decoded models around the agent's own decoded copy;
    residuals carry the compression error to the next round. On the
    sparse path int wires go to the fused dequantizing kernel as int8
    lanes; other codecs decode first and reuse the plain kernel.

    This is the wire's mechanism, not its bill: the drivers price each
    round once through ``ConsensusEngine.round_comm_joules`` (Eq. 11).
    """
    from repro_torch.comms import codecs
    from repro_torch.kernels import ops

    base = codec.inner if isinstance(codec, codecs.ErrorFeedback) else codec
    stateful = isinstance(codec, codecs.ErrorFeedback)
    if impl == "auto":
        impl = auto_path(mix, codec=base)
    device = _device_of(stacked_params)
    if impl == "sparse":
        idx, sig = _structure(mix, structure, device)
        sig = gamma * sig
    else:
        M = (mix.to(device, torch.float32) if isinstance(mix, torch.Tensor)
             else torch.as_tensor(np.asarray(mix, np.float32), device=device))
        off = gamma * (M - torch.diag(torch.diag(M)))
        rowsum = off.sum(dim=1)

    if stateful:
        if codec_state is None:
            codec_state = codec.init_state(stacked_params)
        if set(codec_state) != set(stacked_params):
            raise ValueError(
                f"codec_state has leaves {sorted(codec_state)} but the "
                f"params have {sorted(stacked_params)} — thread the state "
                "returned by the previous step (or None for zeros)")

    new_params, new_state = {}, {}
    for name, x in stacked_params.items():
        K = x.shape[0]
        xf = x.to(torch.float32).reshape(K, -1)
        residual = codec_state[name].reshape(K, -1) if stateful else None
        enc, xhat, r_new = codec.transmit(xf, residual, generator)
        if stateful:
            new_state[name] = r_new.reshape(x.shape)

        if impl == "sparse" and isinstance(base, codecs.IntCodec):
            y = ops.quant_consensus_pop(xf, enc["q"], enc["scale"], idx, sig,
                                        qblock=base.block)
        elif impl == "sparse":
            y = xf + (ops.consensus_update_pop(xhat, idx, sig) - xhat)
        else:
            y = xf + off @ xhat - rowsum[:, None] * xhat
        new_params[name] = y.reshape(x.shape).to(x.dtype)
    return new_params, (new_state if stateful else None)


def consensus_error(stacked_params) -> torch.Tensor:
    """Mean squared deviation from the agent average (0 ⇒ consensus)."""
    tot, n = 0.0, 0
    for x in stacked_params.values():
        xf = x.to(torch.float32)
        dev = xf - xf.mean(dim=0, keepdim=True)
        tot = tot + dev.square().sum()
        n += dev.numel()
    return tot / n
