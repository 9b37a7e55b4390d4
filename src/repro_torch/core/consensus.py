"""Decentralized federated learning by average consensus — paper Eq. (6).

    W^{(k)}_{t+1} = W^{(k)}_t + Σ_{h∈N_k} σ_{k,h} (W^{(h)}_t − W^{(k)}_t),
    σ_{k,h} = |E_h| / Σ_{j∈N_k} |E_j|

Numpy helpers build the σ matrix, the sparse neighbour tables and the
permutation schedule; the step functions mix agent-stacked params (a dict
of (K, ...) tensors):

* ``consensus_step(impl="dense")``  — one (K, K) matmul per leaf (the
  reference);
* ``consensus_step(impl="sparse")`` — one launch per leaf of the
  population-level consensus kernels in :mod:`repro_torch.kernels.ops`,
  gathering each agent's H neighbour rows straight from the (K, N) stack;
  int wires stay int8 lanes into the fused dequantizing kernel;
  ``impl="auto"`` lets :func:`auto_path` pick one of the two;
* :func:`sharded_consensus_step` — the population in ``num_blocks``
  blocks of agents: each block encodes its own rows, the (K, ·) codec
  wire is gathered (``all_gather_into_tensor`` over a process group, or
  the concatenation of the block wires in one process), and each block
  mixes its own rows from the gathered wire, one kernel launch per block
  per leaf;
* :func:`distributed_consensus_step` — one agent per position; neighbour
  wires travel in the slots of :func:`permutation_schedule`
  (``batch_isend_irecv`` over a process group, or, in one process, the
  schedule as (K, M) kernel lanes, one launch per leaf).

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
#: matmul, set on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
#: the JAX package's own rule (the K·H of the first f32 row where the
#: sparse plan beats the dense one, every row below it losing) from three
#: runs of ``python -m repro_torch.launch.consensus_scale --n-params
#: 2048,262144,811012`` with the plans timed in turns (PERF.md §6). The
#: sweep has no row between K·H = 2 and 24. At 2, the case study's own
#: 2-robot cluster engine (the whole paper-DQN in 10 leaves), the sparse
#: plan lost in all three runs (0.71×, 0.74×, 0.71×: each B2 launch costs
#: more host time than the dense plan's small matmul). At 24 (the K = 12
#: ring) it won in all three, the smallest K·H where it did. Rows near
#: the floor swing between winning and losing, within noise: one run read
#: 0.92× for the K = 12 cluster at K·H = 36 (its quartiles overlap the
#: dense plan's), and an earlier run that timed the plans one after the
#: other read 0.88× for the K = 12 ring at N = 262,144. The JAX package
#: keeps its CPU calibration, 512.
SPARSE_GATHER_FLOOR = 24


def _max_degree(mix):
    """(K, H): population size and max off-diagonal degree of a mix."""
    M = np.asarray(mix)
    K = M.shape[0]
    off = M.copy()
    np.fill_diagonal(off, 0.0)
    return K, (int((off != 0).sum(axis=1).max()) if K else 0)


def auto_path(mix, codec=None) -> str:
    """``"sparse"`` while the graph is sparse enough for the gather to
    beat the dense matmul, else ``"dense"``.

    Below :data:`SPARSE_GATHER_FLOOR` total gather work (K · max degree)
    the population stays dense; above it :func:`degree_path` decides."""
    K, H = _max_degree(mix)
    if K * max(float(H), 1.0) < SPARSE_GATHER_FLOOR:
        return "dense"
    return degree_path(mix, codec)


def degree_path(mix, codec=None) -> str:
    """The degree test of :func:`auto_path` alone: ``"sparse"`` unless the
    max degree exceeds K/4. With an int ``codec`` the gathered payload is
    int8 lanes (plus block scales), so the degree is discounted by the
    wire's bytes per parameter first; every other codec decodes to f32
    before the gather and counts at full width."""
    K, H = _max_degree(mix)
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
    nz = M != 0
    np.fill_diagonal(nz, False)
    idx, rows, pos, cols = neighbour_lanes(nz)
    sig = np.zeros(idx.shape, np.float32)
    sig[rows, pos] = M[rows, cols]
    return idx, sig


def is_symmetric(nz) -> bool:
    """Whether a (K, K) bool mask equals its transpose, from its nonzero
    positions alone (O(nnz) after one flat scan; the dense transposed
    comparison walks the matrix column-wise)."""
    K = nz.shape[0]
    flat = np.flatnonzero(nz)
    rows, cols = np.divmod(flat, K)
    return bool(np.array_equal(np.sort(cols * K + rows), flat))


def neighbour_lanes(nz):
    """Lane table of a (K, K) bool neighbour mask: ``idx`` (K, H) int32
    with row k's neighbours in ascending order, padded with k itself, H =
    max(max degree, 1); and the (rows, lane positions, neighbours) of the
    real lanes, for filling per-lane values."""
    K = nz.shape[0]
    # row-major flat positions: each row's neighbours come out ascending
    rows, cols = np.divmod(np.flatnonzero(nz), K)
    deg = np.bincount(rows, minlength=K)
    H = max(int(deg.max()), 1) if K else 1
    idx = np.tile(np.arange(K, dtype=np.int32)[:, None], (1, H))
    pos = np.arange(rows.size) - np.repeat(np.cumsum(deg) - deg, deg)
    idx[rows, pos] = cols
    return idx, rows, pos, cols


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
                   structure=None, dense_operator=None):
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
    tensor, a round's σ rebuilt on the card, and ``dense_operator`` the
    (K, K) f32 matrix the dense path multiplies by, already on the
    params' device (``_effective_mix(mix)`` without a codec, ``mix``
    itself with one): the engine keeps its static σ there, so a captured
    round copies nothing from the host.
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
            gamma=gamma, structure=structure, dense_operator=dense_operator)
    if impl == "auto":
        impl = auto_path(mix)
    device = _device_of(stacked_params)
    out = {}
    if impl == "dense":
        M = (dense_operator if dense_operator is not None
             else torch.as_tensor(_effective_mix(mix), device=device))
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
                               structure=None, dense_operator=None):
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
        M = (dense_operator if dense_operator is not None
             else mix.to(device, torch.float32)
             if isinstance(mix, torch.Tensor)
             else torch.as_tensor(np.asarray(mix, np.float32), device=device))
        off = gamma * (M - torch.diag(torch.diag(M)))
        rowsum = off.sum(dim=1)

    codec_state = _check_state(codec, codec_state, stacked_params)

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


# ---------------------------------------------------------------------------
# the mesh plans: sharded blocks and one agent per position
# ---------------------------------------------------------------------------


def permutation_schedule(mix, gamma: float = 1.0):
    """Decompose a concrete σ matrix into permutation slots for the
    distributed plan: a list of ``(pairs, sig)``, ``pairs`` a full
    source→target permutation of the K positions and ``sig`` the (K,)
    Eq.-(6) weights each target applies to what it receives in that slot
    (γ·σ_{tgt,src}; 0 where the slot carries no real edge for it).

    Greedy maximal-matching cover: every directed edge rides exactly one
    slot, so the slot count is at least the max degree and usually equal
    to it (ring: 2). Each matching is completed to a full permutation; the
    completion lanes carry σ = 0, an exact no-op in Eq. (6). The JAX
    package's schedule, pairs and σ alike."""
    M = np.asarray(mix, np.float32)
    K = M.shape[0]
    off = M.copy()
    np.fill_diagonal(off, 0.0)
    edges = {(k, h) for k in range(K)
             for h in np.flatnonzero(off[k] != 0.0)}
    schedule = []
    while edges:
        used_src, used_tgt = set(), set()
        pairs, sig = [], np.zeros(K, np.float32)
        for k, h in sorted(edges):
            if h in used_src or k in used_tgt:
                continue
            pairs.append((h, k))
            sig[k] = gamma * off[k, h]
            used_src.add(h)
            used_tgt.add(k)
        edges -= {(tgt, src) for src, tgt in pairs}
        free_src = [s for s in range(K) if s not in used_src]
        free_tgt = [t for t in range(K) if t not in used_tgt]
        pairs.extend(zip(free_src, free_tgt))
        schedule.append((tuple(pairs), sig))
    return schedule


def schedule_sources(schedule, K: int) -> np.ndarray:
    """(M, K) int32: the position each target receives from in slot m."""
    srcs = np.zeros((len(schedule), K), np.int32)
    for m, (pairs, _sig) in enumerate(schedule):
        for src, tgt in pairs:
            srcs[m, tgt] = src
    return srcs


def mesh_axis_size(mesh, axis_name: str):
    """Size of ``mesh``'s ``axis_name`` dimension (None without a mesh or
    without that axis). ``mesh`` is a
    ``torch.distributed.device_mesh.DeviceMesh``."""
    if mesh is None:
        return None
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis_name not in names:
        return None
    return int(mesh.size(names.index(axis_name)))


def _encode_rows(codec, xf, residual, generator, noise=None):
    """One leaf's rows onto the wire: ``(payload, x̂, residual')``. Without
    a codec the payload is the f32 rows themselves. ``noise``: the rows'
    rounding noise already drawn (:func:`_emulation_noise`)."""
    if codec is None:
        return {"v": xf}, xf, None
    return codec.transmit(xf, residual, generator, noise)


def _emulation_noise(codec, generator, n: int, draws: int, rows: int,
                     keep: slice, device):
    """The stochastic-rounding noise of the population rows ``keep`` of
    one leaf of width ``n``, as the one-process emulation draws it: that
    run encodes ``draws`` groups of ``rows`` rows in turn (the sharded
    plan's blocks, or the distributed plan's one (K, n) draw), each
    drawing ``codec.noise_shape(rows, n)`` from ``generator``. A process
    on the mesh makes the same draws in the same shapes and order (a
    single larger draw would not give the same numbers on the card) and
    keeps its own rows, so its rows get the emulation's noise and the
    generator ends in the emulation's state. None without a generator or
    for a codec that draws nothing."""
    shape = None if codec is None else codec.noise_shape(rows, n)
    if generator is None or shape is None:
        return None
    kept = []
    for d in range(draws):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        lo = d * rows
        a, b = max(lo, keep.start), min(lo + rows, keep.stop)
        if a < b:
            kept.append(u[a - lo:b - lo])
    return kept[0] if len(kept) == 1 else torch.cat(kept)


def gather_population(stacked_params, mesh, axis_name: str = "agents"):
    """The whole (K, ...) population from each position's rows on
    ``mesh``, the same bits on every process: every leaf's rows viewed
    as bytes and packed into one buffer, ONE ``all_gather`` over the
    agent axis, unpacked in position order. It moves K x (one agent's
    bytes) per call, the quantity ``ConsensusEngine.audit_meta()`` names
    as the population gather (an observer collective: what the drivers'
    ``target_fn`` evaluates, never a model exchange, so Eq. (11) does not
    bill it). Only the evaluated rounds call it."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    names = list(stacked_params)
    rows = next(iter(stacked_params.values())).shape[0]
    parts = [stacked_params[k].contiguous().reshape(rows, -1)
             .view(torch.uint8) for k in names]
    mine = torch.cat(parts, dim=1)
    bufs = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, mine, group=group)
    whole = bufs[0] if len(bufs) == 1 else torch.cat(bufs)
    out, at = {}, 0
    for k, part in zip(names, parts):
        x = stacked_params[k]
        width = part.shape[1]
        out[k] = whole[:, at:at + width].contiguous().view(x.dtype).reshape(
            (whole.shape[0],) + tuple(x.shape[1:]))
        at += width
    return out


def _int_wire(codec):
    """The IntCodec under ``codec`` (its wire stays int8 lanes into B1),
    else None."""
    from repro_torch.comms import codecs
    base = codec.inner if isinstance(codec, codecs.ErrorFeedback) else codec
    return base if isinstance(base, codecs.IntCodec) else None


def _source(codec, wire, n: int):
    """What the neighbours are read from: the f32 rows without a codec,
    the int8 lanes and scales of an int wire, else the decoded wire."""
    if codec is None:
        return wire["v"]
    if _int_wire(codec) is not None:
        return wire
    return codec.decode_leaf(wire, n)


def _mix_rows(codec, xf, payload, xhat, source, idx, sig):
    """Mix K owned rows ``xf`` from a (Ks, ·) ``source`` (:func:`_source`)
    through B1/B2, each owned row recentred on its own decoded copy
    ``xhat``: int wires stay int8 lanes into the fused dequantizing
    kernel; every other codec mixes decoded rows, as the sparse plan
    does."""
    from repro_torch.kernels import ops

    if codec is None:
        return ops.consensus_update_pop(xf, idx, sig, src=source)
    base = _int_wire(codec)
    if base is not None:
        return ops.quant_consensus_pop(xf, payload["q"], payload["scale"],
                                       idx, sig, qblock=base.block,
                                       q_src=source["q"],
                                       s_src=source["scale"])
    return xf + (ops.consensus_update_pop(xhat, idx, sig, src=source) - xhat)


def _check_state(codec, codec_state, stacked_params):
    """The stacked error-feedback residuals (zeros when None), or None for
    a stateless codec."""
    if codec is None or not codec.stateful:
        return None
    if codec_state is None:
        return codec.init_state(stacked_params)
    if set(codec_state) != set(stacked_params):
        raise ValueError(
            f"codec_state has leaves {sorted(codec_state)} but the params "
            f"have {sorted(stacked_params)} — thread the state returned by "
            "the previous step (or None for zeros)")
    return codec_state


def sharded_consensus_step(stacked_params, mix, *, num_blocks: int,
                           axis_name: str = "agents", mesh=None,
                           codec=None, codec_state=None, generator=None,
                           gamma: float = 1.0, error_feedback: bool = True,
                           structure=None):
    """Eq. (6) on the sharded plan: the K agents split into ``num_blocks``
    contiguous blocks of B = K / num_blocks. Per leaf, each block encodes
    its own rows, the (K, ·) wire (codec bytes, not f32) is gathered, and
    each block mixes its own rows from it: one B1/B2 launch per block.
    No (K, K) buffer and no (K, H, N) neighbour tensor exist.

    With ``mesh`` (a ``DeviceMesh`` whose ``axis_name`` dimension has
    ``num_blocks`` positions) each process holds ITS block, (B, ...) rows,
    and the wire travels by ``all_gather_into_tensor``; without it
    ``stacked_params`` is the whole (K, ...) population and the blocks run
    in turn in this process, the same per-block functions with the
    all_gather replaced by the concatenation of the block wires. With
    round-to-nearest (``generator=None``) either is bit-identical to the
    sparse plan at any ``num_blocks`` that divides K. With a generator the
    one-process run draws each block's rounding noise in turn; a process
    on the mesh draws every block's the same way and keeps its own
    (:func:`_emulation_noise`), so the two agree bit for bit and leave the
    generator in the same state.

    ``structure``: a round's ``(idx, sig)`` lanes over the whole
    population ((K, H), e.g. σ renormalised on surviving lanes; faded lanes
    carry σ = 0). Returns ``(params, codec_state)``.
    """
    from repro_torch.comms import codecs
    mix = resolve_mix(mix)
    codec = codecs.resolve_codec(codec, error_feedback)
    K = (np.asarray(mix).shape[0] if structure is None
         else int(structure[0].shape[0]))
    if num_blocks < 1 or K % num_blocks:
        raise ValueError(
            f"num_blocks={num_blocks} must divide the population K={K}; "
            "pick a divisor of K")
    B = K // num_blocks
    use_mesh = mesh_axis_size(mesh, axis_name) == num_blocks
    rows = next(iter(stacked_params.values())).shape[0]
    want = B if use_mesh else K
    if rows != want:
        what = ("this position's block" if use_mesh
                else "the whole population")
        raise ValueError(
            f"the sharded plan takes {want} rows per process (K={K}, "
            f"num_blocks={num_blocks}, mesh={'yes' if use_mesh else 'no'}), "
            f"got {rows}: pass {what}")
    device = _device_of(stacked_params)
    idx, sig = _structure(mix, structure, device)
    sig = gamma * sig
    state = _check_state(codec, codec_state, stacked_params)
    # ``blocks``: the population rows each block owns (indexing the lane
    # tables); ``local``: the same rows in ``stacked_params``
    if use_mesh:
        import torch.distributed as dist
        group = mesh.get_group(axis_name)
        r = mesh.get_local_rank(axis_name)
        blocks, local = [slice(r * B, (r + 1) * B)], [slice(0, B)]
    else:
        blocks = [slice(b * B, (b + 1) * B) for b in range(num_blocks)]
        local = blocks

    new_params, new_state = {}, {}
    for name, x in stacked_params.items():
        xf = x.to(torch.float32).reshape(rows, -1)
        rf = None if state is None else state[name].reshape(rows, -1)
        r_out = None if state is None else torch.empty_like(rf)
        # on the mesh: every block's draws, this block's noise kept
        noise = (_emulation_noise(codec, generator, xf.shape[1], num_blocks,
                                  B, blocks[0], device) if use_mesh else None)
        payloads = []
        for lb in local:
            payload, _xhat, r_new = _encode_rows(
                codec, xf[lb], None if rf is None else rf[lb], generator,
                noise)
            if r_out is not None:
                r_out[lb] = r_new
            payloads.append(payload)
        wire = {}
        for key, part in payloads[0].items():
            buf = torch.empty((K,) + tuple(part.shape[1:]), dtype=part.dtype,
                              device=device)
            if use_mesh:
                dist.all_gather_into_tensor(buf, part.contiguous(),
                                            group=group)
            else:
                for gb, payload in zip(blocks, payloads):
                    buf[gb] = payload[key]
            wire[key] = buf
        del payloads[:]             # the wire holds every block's payload
        source = _source(codec, wire, xf.shape[1])
        decoded = codec is not None and _int_wire(codec) is None
        y = torch.empty_like(xf)
        for lb, gb in zip(local, blocks):
            # a block's own decoded copy is its rows of the decoded wire
            own = {k: v[gb] for k, v in wire.items()}
            y[lb] = _mix_rows(codec, xf[lb], own,
                              source[gb] if decoded else None, source,
                              idx[gb], sig[gb])
        new_params[name] = y.reshape(x.shape).to(x.dtype)
        if r_out is not None:
            new_state[name] = r_out.reshape(x.shape)
    return new_params, (new_state if state is not None else None)


def distributed_consensus_step(stacked_params, mix, *,
                               axis_name: str = "agents", mesh=None,
                               codec=None, codec_state=None, generator=None,
                               gamma: float = 1.0,
                               error_feedback: bool = True,
                               schedule=None, sig_override=None,
                               sources=None):
    """Eq. (6) on the distributed plan: one agent per position, neighbour
    wires carried by the slots of :func:`permutation_schedule`, the codec
    wire (int8 lanes and scales, bf16, ...) as the payload.

    With ``mesh`` (a ``DeviceMesh`` whose ``axis_name`` dimension has K
    positions) each process holds its one agent, (1, ...) rows, ships its
    wire in every slot and receives M payloads by ``batch_isend_irecv``,
    then mixes its row from them (one B1/B2 launch per leaf, the M
    payloads as the source). Without it the schedule becomes kernel lanes
    over the whole (K, ...) population, ``idx = srcs.T`` and ``sig`` the
    (K, M) slot weights, one launch per leaf; completion slots carry σ = 0.
    Both sum the slots in schedule order, so they agree bit for bit. With
    a generator each position draws the one-process run's (K, ·) rounding
    noise and keeps its own row (:func:`_emulation_noise`).

    ``sig_override``: (K, M) per-slot weights replacing the schedule's
    γ·σ for this round (σ renormalised on surviving slots). ``sources``:
    the schedule's (M, K) sources (:func:`schedule_sources`), e.g. a
    tensor already on the device. Returns ``(params, codec_state)``.
    """
    from repro_torch.comms import codecs
    mix = resolve_mix(mix)
    codec = codecs.resolve_codec(codec, error_feedback)
    if schedule is None:
        schedule = permutation_schedule(mix, gamma)
    K = np.asarray(mix).shape[0]
    M = len(schedule)
    device = _device_of(stacked_params)
    if sig_override is not None:
        sig_stack = torch.as_tensor(sig_override, dtype=torch.float32,
                                    device=device)
        if tuple(sig_stack.shape) != (K, M):
            raise ValueError(
                f"sig_override is {tuple(sig_stack.shape)}, the schedule "
                f"wants (K={K}, M={M})")
    else:
        sig_stack = torch.as_tensor(
            np.stack([s for _, s in schedule], axis=1) if M
            else np.zeros((K, 0), np.float32), device=device)
    use_mesh = mesh_axis_size(mesh, axis_name) == K
    rows = next(iter(stacked_params.values())).shape[0]
    if rows != (1 if use_mesh else K):
        raise ValueError(
            f"the distributed plan {'on a mesh ' if use_mesh else ''}takes "
            f"{1 if use_mesh else K} rows per process (K={K}), got {rows}")
    state = _check_state(codec, codec_state, stacked_params)
    if use_mesh:
        r = mesh.get_local_rank(axis_name)
        idx = torch.arange(max(M, 1), dtype=torch.int32,
                           device=device)[None, :]
        sig = (sig_stack[r:r + 1] if M
               else torch.zeros((1, 1), dtype=torch.float32, device=device))
    elif M:
        srcs = (schedule_sources(schedule, K) if sources is None
                else sources)
        idx = torch.as_tensor(srcs, device=device).T.contiguous().to(
            torch.int32)
        sig = sig_stack
    else:                       # no edges: one σ = 0 lane, an exact no-op
        idx = torch.arange(K, dtype=torch.int32, device=device)[:, None]
        sig = torch.zeros((K, 1), dtype=torch.float32, device=device)

    new_params, new_state = {}, {}
    for name, x in stacked_params.items():
        xf = x.to(torch.float32).reshape(rows, -1)
        rf = None if state is None else state[name].reshape(rows, -1)
        # on the mesh: the emulation's one (K, n) draw, this agent's row kept
        noise = (_emulation_noise(codec, generator, xf.shape[1], 1, K,
                                  slice(r, r + 1), device)
                 if use_mesh else None)
        payload, xhat, r_new = _encode_rows(codec, xf, rf, generator, noise)
        wire = (_exchange_slots(mesh, axis_name, payload, schedule)
                if use_mesh else payload)
        y = _mix_rows(codec, xf, payload, xhat,
                      _source(codec, wire, xf.shape[1]), idx, sig)
        new_params[name] = y.reshape(x.shape).to(x.dtype)
        if state is not None:
            new_state[name] = r_new.reshape(x.shape)
    return new_params, (new_state if state is not None else None)


def _exchange_slots(mesh, axis_name, payload, schedule):
    """This position's M received payloads, stacked slot by slot: in slot
    m it sends its own payload to its target and receives its source's, by
    ``batch_isend_irecv`` (a slot that pairs the position with itself is a
    local copy). Without slots, the position's own payload (σ = 0)."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    r = mesh.get_local_rank(axis_name)
    M = len(schedule)
    if M == 0:
        return payload
    peer = dist.get_global_rank
    wire = {key: torch.empty((M,) + tuple(t.shape[1:]), dtype=t.dtype,
                             device=t.device)
            for key, t in payload.items()}
    ops = []
    for m, (pairs, _sig) in enumerate(schedule):
        dst = next(t for s, t in pairs if s == r)
        src = next(s for s, t in pairs if t == r)
        for key, t in payload.items():
            if src == r:
                wire[key][m:m + 1] = t
                continue
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  peer(group, dst), group))
            ops.append(dist.P2POp(dist.irecv, wire[key][m:m + 1],
                                  peer(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return wire
