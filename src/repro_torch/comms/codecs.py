"""Model-exchange codecs — the "bytes knob" of the paper's Eq. (11).

A :class:`Codec` maps each agent's flattened parameter tensor to a wire
payload and back, and prices the wire exactly in bits:

    payload = codec.encode_leaf(rows, generator)   # rows: (K, n) f32
    rows'   = codec.decode_leaf(payload, n)        # (K, n) f32
    payload, rows', residual' = codec.transmit(rows, residual, generator)
    codec.leaf_bits(shape) / model_bits(tree)      # EXACT wire bits
    codec.price_bits(full_bits)                    # static Eq.-(11) pricing

Leaf methods work on agent-stacked rows: row k is agent k's tensor,
flattened, and is quantized on its own (per-(agent, tensor) scales) —
what the JAX package gets by ``vmap`` over the agent axis. The tree API
codes ONE model's pytree, each leaf one row of the leaf API:

    wire  = codec.encode(tree, generator)          # a Wire
    tree' = codec.decode(wire)
    codec.bits(wire)                               # EXACT wire bits

* ``IdentityCodec`` — f32 passthrough (32 bit/param).
* ``Bf16Codec``     — bf16 cast (16 bit/param).
* ``IntCodec(8|4)`` — absmax-scaled integers in int8 lanes (int4 priced at
  4 bits) with one f32 scale per tensor, or one per ``block`` run
  (``"int8:b64"``). Round half to even without a generator, unbiased
  ``floor(y + u)`` with one.
* ``TopKCodec``     — magnitude top-k; (int32 index, f32 value) pairs.
* ``ErrorFeedback`` — residual wrapper: encode x + r, r ← (x + r) − x̂.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

F32_BITS = 32.0
SCALE_BITS = 32.0        # one f32 scale per quantized tensor
IDX_BITS = 32.0          # int32 index per kept top-k entry


class LeafMeta(NamedTuple):
    """Shape and dtype of one coded leaf."""

    shape: tuple
    dtype: torch.dtype


@dataclass
class Wire:
    """A codec'd pytree: one payload per leaf (dicts of tensors, each the
    leaf's row of :meth:`Codec.encode_leaf` with the row axis dropped:
    flat values, a 0-d scale per tensor or an (nb,) scale per block) and
    the tree's structure."""

    codec: str
    payloads: List[Any]
    treedef: Any
    leaves_meta: List[LeafMeta]

    def __iter__(self):                    # allow tuple-unpacking styles
        return iter((self.codec, self.payloads))


def _stochastic_round(y: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
    """floor(y + u), u ~ U[0, 1): unbiased rounding; round half to even
    without a generator. ``noise``: u already drawn (y's shape), in place
    of a draw from ``generator``."""
    if noise is not None:
        return torch.floor(y + noise.reshape(y.shape))
    if generator is None:
        return torch.round(y)
    u = torch.rand(y.shape, generator=generator, dtype=torch.float32,
                   device=y.device)
    return torch.floor(y + u)


class Codec:
    """Uniform model-exchange compression API (see module docstring)."""

    name: str = "codec"
    stateful: bool = False
    #: wire bits per parameter (None when size-dependent, e.g. absolute
    #: top-k) — drives the consensus auto dense-vs-sparse heuristic.
    bits_per_param: Optional[float] = None

    def encode_leaf(self, rows, generator=None, noise=None) -> dict:
        raise NotImplementedError

    def noise_shape(self, rows: int, n: int):
        """Shape of the U[0, 1) tensor :meth:`encode_leaf` draws from a
        generator for ``rows`` rows of width ``n`` (the tensor its
        ``noise=`` takes instead), or None when it draws nothing."""
        return None

    def decode_leaf(self, payload: dict, n: int) -> torch.Tensor:
        """(K, n) f32 rows from a payload."""
        raise NotImplementedError

    def transmit(self, rows, residual=None, generator=None, noise=None):
        """One agent-stacked leaf over the wire: ``(payload, x̂, residual)``,
        x̂ the decoded (K, n) f32 rows the receivers see, ``residual`` the
        new error-feedback state (None for a stateless codec). The wire is
        billed per round by ``Topology.round_comm_joules(codec=...)``."""
        payload = self.encode_leaf(rows, generator, noise)
        return payload, self.decode_leaf(payload, rows.shape[1]), None

    def leaf_bits(self, shape) -> float:
        """EXACT wire bits for one tensor of ``shape``."""
        raise NotImplementedError

    # -- pytree level ---------------------------------------------------------
    def encode(self, tree, generator=None) -> Wire:
        """One model's pytree over the wire, each leaf flattened into one
        row of :meth:`encode_leaf` (its own scales). ``generator`` draws
        the stochastic rounding of every leaf in turn (None: round to
        nearest)."""
        leaves, treedef = tree_flatten(tree)
        payloads = []
        for x in leaves:
            p = self.encode_leaf(x.reshape(1, -1), generator)
            payloads.append({k: v[0] for k, v in p.items()})
        return Wire(self.name, payloads, treedef,
                    [LeafMeta(tuple(x.shape), x.dtype) for x in leaves])

    def decode(self, wire: Wire):
        """The pytree a :class:`Wire` carries, each leaf in its shape and
        dtype."""
        leaves = []
        for p, m in zip(wire.payloads, wire.leaves_meta):
            rows = self.decode_leaf({k: v[None] for k, v in p.items()},
                                    math.prod(m.shape))
            leaves.append(rows.reshape(m.shape).to(m.dtype))
        return tree_unflatten(leaves, wire.treedef)

    def bits(self, wire: Wire) -> float:
        """Exact wire size of one encoded model, in bits."""
        return float(sum(self.leaf_bits(m.shape) for m in wire.leaves_meta))

    def model_bits(self, tree) -> float:
        """Exact wire bits this codec would use for ``tree`` (a dict of
        one model's tensors)."""
        return float(sum(self.leaf_bits(tuple(x.shape))
                         for x in tree.values()))

    def price_bits(self, full_bits: float,
                   ref_bits: float = F32_BITS) -> float:
        """Wire bits of a model whose full-precision size is
        ``full_bits`` (b(W)); per-tensor scale overhead excluded."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class IdentityCodec(Codec):
    """f32 passthrough — the uncompressed baseline."""

    name = "none"
    bits_per_param = F32_BITS

    def encode_leaf(self, rows, generator=None, noise=None):
        return {"v": rows.to(torch.float32)}

    def decode_leaf(self, payload, n):
        return payload["v"]

    def leaf_bits(self, shape) -> float:
        return F32_BITS * math.prod(shape)

    def price_bits(self, full_bits, ref_bits=F32_BITS):
        return full_bits * F32_BITS / ref_bits


class Bf16Codec(Codec):
    """bf16 cast: 16 bit/param."""

    name = "bf16"
    bits_per_param = 16.0

    def encode_leaf(self, rows, generator=None, noise=None):
        return {"v": rows.to(torch.bfloat16)}

    def decode_leaf(self, payload, n):
        return payload["v"].to(torch.float32)

    def leaf_bits(self, shape) -> float:
        return 16.0 * math.prod(shape)

    def price_bits(self, full_bits, ref_bits=F32_BITS):
        return full_bits * 16.0 / ref_bits


class IntCodec(Codec):
    """Absmax-scaled ``bits``-bit integer quantization.

    q = clip(round(x / s), ±qmax), s = absmax / qmax. q rides int8 lanes
    (int4 values too, priced at 4 bits); scales are f32, one per tensor
    (``block=None``) or one per consecutive ``block``-long run of the
    flattened tensor.
    """

    def __init__(self, bits: int, block: Optional[int] = None):
        if bits not in (4, 8):
            raise ValueError(f"IntCodec supports 4/8 bits, got {bits}")
        if block is not None and block < 1:
            raise ValueError(f"block size must be >= 1, got {block}")
        self.qbits = bits
        self.qmax = float(2 ** (bits - 1) - 1)
        self.block = block
        self.name = f"int{bits}" + ("" if block is None else f":b{block}")
        self.bits_per_param = float(bits)

    def _blocked(self, rows):
        """(K, nb, block) view of (K, n) rows, zero-padded on the right."""
        K, n = rows.shape
        nb = -(-n // self.block)
        pad = nb * self.block - n
        if pad:
            rows = torch.nn.functional.pad(rows, (0, pad))
        return rows.reshape(K, nb, self.block)

    def noise_shape(self, rows, n):
        if self.block is None:
            return (rows, n)
        return (rows, -(-n // self.block), self.block)

    def encode_leaf(self, rows, generator=None, noise=None):
        xf = rows.to(torch.float32)
        if self.block is None:
            absmax = xf.abs().amax(dim=1)
            scale = absmax.clamp_min(1e-12) / self.qmax
            q = _stochastic_round(xf / scale[:, None], generator, noise)
            q = q.clamp(-self.qmax, self.qmax).to(torch.int8)
            return {"q": q, "scale": scale}
        n = xf.shape[1]
        blocks = self._blocked(xf)
        absmax = blocks.abs().amax(dim=2)
        scale = absmax.clamp_min(1e-12) / self.qmax
        q = _stochastic_round(blocks / scale[:, :, None], generator, noise)
        q = q.clamp(-self.qmax, self.qmax).to(torch.int8)
        return {"q": q.reshape(xf.shape[0], -1)[:, :n].contiguous(),
                "scale": scale}

    def decode_leaf(self, payload, n):
        q = payload["q"].to(torch.float32)
        if self.block is None:
            return q * payload["scale"][:, None]
        blocks = self._blocked(q)
        y = (blocks * payload["scale"][:, :, None]).reshape(q.shape[0], -1)
        return y[:, :n]

    def _num_scales(self, n: int) -> int:
        return 1 if self.block is None else -(-n // self.block)

    def leaf_bits(self, shape) -> float:
        n = math.prod(shape)
        return float(self.qbits) * n + SCALE_BITS * self._num_scales(n)

    def price_bits(self, full_bits, ref_bits=F32_BITS):
        wire = full_bits * self.qbits / ref_bits
        if self.block is not None:
            # block scales are not negligible at small blocks: price them
            # (treating the model as one flat tensor)
            wire += SCALE_BITS * math.ceil(full_bits / ref_bits / self.block)
        return wire


class TopKCodec(Codec):
    """Magnitude top-k sparsification over each flattened tensor.

    ``k``: fraction kept when < 1, absolute count otherwise. Wire per
    tensor: k' (int32 idx, f32 value) pairs, 64 bits each.
    """

    def __init__(self, k: float = 0.05):
        if k <= 0:
            raise ValueError(f"top-k needs k > 0, got {k}")
        self.k = k
        self.name = f"topk:{k:g}"
        self.bits_per_param = k * (IDX_BITS + F32_BITS) if k < 1 else None

    def _k_of(self, n: int) -> int:
        if self.k < 1:
            return max(1, int(round(self.k * n)))
        return min(int(self.k), n)

    def encode_leaf(self, rows, generator=None, noise=None):
        flat = rows.to(torch.float32)
        k = self._k_of(flat.shape[1])
        idx = torch.topk(flat.abs(), k, dim=1).indices
        return {"idx": idx.to(torch.int32), "val": flat.gather(1, idx)}

    def decode_leaf(self, payload, n):
        val = payload["val"]
        y = torch.zeros((val.shape[0], n), dtype=torch.float32,
                        device=val.device)
        return y.scatter(1, payload["idx"].long(), val)

    def leaf_bits(self, shape) -> float:
        return self._k_of(math.prod(shape)) * (IDX_BITS + F32_BITS)

    def price_bits(self, full_bits, ref_bits=F32_BITS):
        """Treats the model as ONE flat tensor (exact for fractional k up
        to per-leaf rounding; use ``model_bits`` for absolute k)."""
        n = full_bits / ref_bits
        if self.k < 1:
            kept = max(1.0, round(self.k * n))
        else:
            kept = min(float(self.k), n)
        return kept * (IDX_BITS + F32_BITS)


class ErrorFeedback(Codec):
    """Residual-accumulating wrapper: encode(x + r), r ← (x + r) − x̂.

    State is a dict of f32 residuals shaped like the (stacked) model.
    """

    stateful = True

    def __init__(self, inner: Codec):
        if isinstance(inner, ErrorFeedback):
            raise ValueError("cannot nest ErrorFeedback")
        self.inner = inner
        self.name = inner.name + "+ef"
        self.bits_per_param = inner.bits_per_param

    def init_state(self, tree):
        return {name: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
                for name, x in tree.items()}

    def transmit(self, rows, residual=None, generator=None, noise=None):
        """(payload, decoded x̂ rows as f32, new residual rows); the JAX
        package's ``encode_leaf_stateful``."""
        m = rows.to(torch.float32) + residual
        payload = self.inner.encode_leaf(m, generator, noise)
        xhat = self.inner.decode_leaf(payload, m.shape[1])
        return payload, xhat, m - xhat

    def encode_leaf(self, rows, generator=None, noise=None):
        return self.inner.encode_leaf(rows, generator, noise)

    def noise_shape(self, rows, n):
        return self.inner.noise_shape(rows, n)

    def decode_leaf(self, payload, n):
        return self.inner.decode_leaf(payload, n)

    def leaf_bits(self, shape) -> float:
        return self.inner.leaf_bits(shape)

    def price_bits(self, full_bits, ref_bits=F32_BITS):
        return self.inner.price_bits(full_bits, ref_bits)


#: canonical sweep order: uncompressed baseline first.
CODECS = ("none", "bf16", "int8", "int4", "topk:0.05")


def get_codec(spec) -> Optional[Codec]:
    """Parse a codec spec: a Codec (returned as-is), None, or a string —
    ``none|f32|identity``, ``bf16``, ``int8``, ``int4`` (optionally
    ``int8:b64`` block scales), ``topk[:k]``, each with an optional
    ``+ef`` error-feedback suffix."""
    if spec is None or isinstance(spec, Codec):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"codec spec must be str/Codec/None, got {spec!r}")
    name = spec.strip().lower()
    ef = name.endswith("+ef")
    if ef:
        name = name[:-3]
    if name in ("none", "f32", "identity"):
        codec = IdentityCodec()
    elif name == "bf16":
        codec = Bf16Codec()
    elif name in ("int8", "int4") or name.startswith(("int8:", "int4:")):
        bits = int(name[3])
        _, _, arg = name.partition(":")
        block = int(arg.lstrip("b")) if arg else None
        codec = IntCodec(bits, block=block)
    elif name.startswith("topk"):
        _, _, arg = name.partition(":")
        codec = TopKCodec(float(arg)) if arg else TopKCodec()
    else:
        raise ValueError(f"unknown codec {spec!r}; "
                         f"choose from {CODECS} (+ optional '+ef')")
    return ErrorFeedback(codec) if ef else codec


def resolve_codec(spec, error_feedback: bool = True) -> Optional[Codec]:
    """``get_codec`` plus the consensus default: wrap lossy codecs in
    :class:`ErrorFeedback` unless already wrapped or disabled."""
    codec = get_codec(spec)
    if codec is None or isinstance(codec, (ErrorFeedback, IdentityCodec)):
        return codec
    return ErrorFeedback(codec) if error_feedback else codec
