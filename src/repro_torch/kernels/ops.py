"""Public wrappers of the hand-written kernels: the two consensus
kernels, the RG-LRU scan and flash attention.

Each wrapper checks dtypes and shapes (the guards of the JAX package's
``kernels/ops.py``), then dispatches BY DEVICE: a tensor on the CPU goes
to the plain version in :mod:`repro_torch.kernels.ref`; a CUDA tensor
launches the CUDA kernel or raises. There is no fallback. A ``meta``
tensor (the dry run, :mod:`repro_torch.launch.dryrun`) computes nothing:
the wrapper returns outputs of the kernel's shapes and dtypes, launches
nothing, and reports the call's bytes and flops
(:mod:`repro_torch.kernels.work`). Any other device raises by name.

Each wrapper counts its launches in a plain integer attribute
(``consensus_update_pop.launches``), raised by one exactly where the
kernel is launched, so a run can show that its main path went through
the kernel.

The two LM kernels are differentiable: each wrapper applies a
``torch.autograd.Function`` whose forward is the dispatch above. Its
backward dispatches by device too: on the CPU it is the vector-Jacobian
product of the plain version at the saved inputs (:func:`torch.func.vjp`,
so it runs inside ``torch.func`` transforms), as in the JAX package,
which differentiates its XLA path and never a Pallas kernel; on the card
it launches the backward kernel (:func:`rglru_scan_backward`, B3′, and
:func:`flash_attention_backward`, B4′) or raises; on ``meta`` it reports
the backward's work. Each backward kernel sits behind a Function of its
own whose backward is the VJP of the plain version's VJP, so a second
derivative is that of the plain version on every device. Under
``torch.func.vmap`` each Function, forward and backward, folds the mapped
axis into the batch and launches its kernel once.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

import torch

from repro_torch.kernels import build, ref, work

_ALLOWED = (torch.float32, torch.bfloat16)
#: qblock the kernel sees for per-tensor scales: larger than any N, so
#: every element reads scale 0, and a multiple of 16 (vector path)
_PER_TENSOR_QBLOCK = 1 << 62
_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F, _PLL = ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)
#: grid limits of the kernels' y/z dimensions and of their int positions
_GRID_YZ, _INT_MAX = 65535, 2**31 - 1


def _lib(name: str, fns):
    lib = build.library(name)
    for fn, argtypes in fns:
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes, f.restype = argtypes, ctypes.c_int
    return lib


def _check_lanes(x, idx, sig, src):
    """Shapes, dtypes and devices of the owned rows ``x`` (K, N), the
    lane tables (K, H) and the neighbour source ``src`` (Ks, ·), whose row
    count bounds the indices."""
    if x.ndim != 2 or idx.ndim != 2 or idx.shape[0] != x.shape[0] \
            or tuple(sig.shape) != tuple(idx.shape) or idx.shape[1] < 1:
        raise ValueError(
            f"bad shapes x {tuple(x.shape)} idx {tuple(idx.shape)} sig "
            f"{tuple(sig.shape)}: want x (K, N), idx and sig (K, H), H >= 1")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32/int64, got {idx.dtype}")
    for name, t in (("idx", idx), ("sig", sig), ("src", src)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    # on the card the kernels check the same bound themselves (a bad index
    # traps the launch before its gather), so no host sync is needed there
    Ks = src.shape[0]
    if x.device.type == "cpu" and not bool(((idx >= 0) & (idx < Ks)).all()):
        raise ValueError(f"neighbour indices must lie in [0, {Ks}), got "
                         f"[{int(idx.min())}, {int(idx.max())}]")


def _cuda_args(x, idx, sig):
    """Contiguous int32/f32 lane tables and the launch limits."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}: pass CPU "
                         "tensors (plain version), CUDA tensors or meta "
                         "tensors (the dry run)")
    K, H = idx.shape
    if H > 6144 or K > 65535:
        raise ValueError(f"K={K} (max 65535) or H={H} (max 6144) exceeds "
                         "the kernel's grid and shared-memory lane table")
    return (idx.to(torch.int32).contiguous(),
            sig.to(torch.float32).contiguous())


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def consensus_update_pop(x, idx, sig, src=None):
    """Fused Eq.-(6) update of K owned rows, one leaf:
    out[k] = x[k] + Σ_h sig[k, h] (src[idx[k, h]] − x[k]).

    x (K, N) f32 or bf16; ``src`` (Ks, N) of x's dtype, the rows the
    neighbours are gathered from (None: the population itself, src = x);
    idx (K, H) indices in [0, Ks) (padding lanes carry sig = 0); sig (K,
    H) f32 → (K, N) in x's dtype, f32 accumulation in fixed h order."""
    if x.dtype not in _ALLOWED:
        raise TypeError(f"unsupported dtype {x.dtype}; use f32/bf16")
    if src is not None and (src.ndim != 2 or src.shape[1:] != x.shape[1:]
                            or src.dtype != x.dtype):
        raise ValueError(f"src {tuple(src.shape)} {src.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}: want (Ks, N)")
    _check_lanes(x, idx, sig, x if src is None else src)
    if x.device.type == "cpu":
        return ref.consensus_update_pop_reference(x, idx, sig, src)
    if x.device.type == "meta":
        work.add("consensus_update_pop", work.consensus_update_pop(
            x.shape[0], x.shape[1], idx.shape[1], x.element_size()))
        return torch.empty_like(x)
    idx32, sig32 = _cuda_args(x, idx, sig)
    x = x.contiguous()
    src = x if src is None else src.contiguous()
    out = torch.empty_like(x)
    K, N = x.shape
    if K == 0 or N == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    fn_name = "consensus_update_pop_bf16" if bf16 else "consensus_update_pop_f32"
    lib = _lib("consensus_update", [
        (n, [_VP, _VP, _VP, _VP, _VP, _LL, _LL, _I, _LL, _I, _VP])
        for n in ("consensus_update_pop_f32", "consensus_update_pop_bf16")])
    vec_ok = int(N % (8 if bf16 else 4) == 0 and _aligned(x, src, out))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(x.data_ptr(), src.data_ptr(),
                                    idx32.data_ptr(), sig32.data_ptr(),
                                    out.data_ptr(), K, N, idx32.shape[1],
                                    src.shape[0], vec_ok, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    consensus_update_pop.launches += 1
    return out


consensus_update_pop.launches = 0


def quant_consensus_pop(x, q, s, idx, sig, qblock: Optional[int] = None,
                        q_src=None, s_src=None):
    """Fused int-wire dequantize + Eq.-(6) update of K owned rows,
    recentred on each agent's own decoded copy:
    out[k] = x[k] + Σ_h sig[k, h] (ŝ_j q_src[j] − s_k q[k]), j = idx[k, h].

    x (K, N) f32; q (K, N) int8 lanes (int8 or int4 values); s (K,) one
    scale per model, or (K, ⌈N/qblock⌉) block scales with ``qblock``
    (the ``"int8:b64"`` wire); ``q_src`` (Ks, N) and ``s_src`` the wire
    the neighbours are gathered from (None: the owned rows' own wire);
    idx, sig (K, H), idx in [0, Ks) → (K, N) f32."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if (q_src is None) != (s_src is None):
        raise ValueError("pass q_src and s_src together (the source wire's "
                         "lanes and scales), or neither")
    if q_src is None:
        q_src, s_src = q, s
    for name, t in (("q", q), ("q_src", q_src)):
        if t.dtype != torch.int8:
            raise TypeError(f"wire lanes {name} must be int8, got {t.dtype}")
    _check_lanes(x, idx, sig, q_src)
    K, N = x.shape
    Ks = q_src.shape[0]
    if tuple(q.shape) != (K, N) or tuple(q_src.shape) != (Ks, N):
        raise ValueError(f"q {tuple(q.shape)} / q_src {tuple(q_src.shape)} "
                         f"do not match x {(K, N)}: want (K, N) / (Ks, N)")
    nb = None if qblock is None else -(-N // int(qblock))
    for name, t, rows in (("s", s, K), ("s_src", s_src, Ks)):
        want = (rows,) if nb is None else (rows, nb)
        if tuple(t.shape) != want:
            raise ValueError(f"qblock={qblock} wants {name} of shape {want}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("q", q), ("s", s), ("s_src", s_src)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.quant_consensus_pop_reference(x, q, s, idx, sig, qblock,
                                                 q_src, s_src)
    if x.device.type == "meta":
        work.add("quant_consensus_pop", work.quant_consensus_pop(
            K, N, idx.shape[1], s.numel()))
        return torch.empty_like(x)
    idx32, sig32 = _cuda_args(x, idx, sig)
    x, q, q_src = x.contiguous(), q.contiguous(), q_src.contiguous()
    s = s.to(torch.float32).contiguous()
    s_src = s_src.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if K == 0 or N == 0:
        return out
    qb = _PER_TENSOR_QBLOCK if qblock is None else int(qblock)
    s_stride = 1 if qblock is None else s.shape[1]
    lib = _lib("quant_consensus", [
        ("quant_consensus_pop",
         [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _I, _LL, _LL,
          _LL, _I, _VP])])
    vec_ok = int(N % 16 == 0 and qb % 16 == 0
                 and _aligned(x, q, q_src, out))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_consensus_pop(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), q_src.data_ptr(),
            s_src.data_ptr(), idx32.data_ptr(), sig32.data_ptr(),
            out.data_ptr(), K, N, idx32.shape[1], Ks, qb, s_stride, vec_ok,
            stream)
    if err != 0:
        raise RuntimeError(f"quant_consensus_pop launch failed: CUDA error {err}")
    quant_consensus_pop.launches += 1
    return out


quant_consensus_pop.launches = 0


def _fold(t, dim, size):
    """A ``torch.func.vmap`` operand with its mapped axis (``dim``; None:
    not mapped, expanded) folded into the leading batch axis."""
    if dim is None:
        t = t.unsqueeze(0).expand(size, *t.shape)
    else:
        t = t.movedim(dim, 0)
    return t.flatten(0, 1)


def _check_dtype(*ts):
    for t in ts:
        if t.dtype not in _ALLOWED:
            raise TypeError(f"unsupported dtype {t.dtype}; use f32/bf16")


def _cuda_only(*ts):
    """The kernels take CUDA tensors of one dtype on one device."""
    x = ts[0]
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}: pass CPU "
                         "tensors (plain version), CUDA tensors or meta "
                         "tensors (the dry run)")
    if any(t.dtype != x.dtype for t in ts):
        raise TypeError("the kernel takes one dtype for all inputs, got "
                        f"{[t.dtype for t in ts]}")


def _on_meta(*ts) -> bool:
    """All of ``ts`` on ``meta`` (the dry run): the wrapper computes
    nothing and reports the call's work."""
    return all(t.device.type == "meta" for t in ts)


def _rglru_scan_forward(log_a, b, h0):
    """The scan's dispatch by device: the plain version on the CPU, the
    kernel on the card (shapes already checked)."""
    B, T, W = log_a.shape
    if log_a.device.type == "cpu" and b.device.type == "cpu" and (
            h0 is None or h0.device.type == "cpu"):
        return ref.rglru_scan_reference(log_a, b, h0)
    if _on_meta(log_a, b, *(() if h0 is None else (h0,))):
        work.add("rglru_scan", work.rglru_scan(
            B, T, W, with_h0=h0 is not None, elem=log_a.element_size()))
        return (torch.empty_like(log_a),
                torch.empty(B, W, dtype=torch.float32, device="meta"))
    _cuda_only(log_a, b)
    if B > _GRID_YZ:
        raise ValueError(f"B={B} exceeds the kernel's grid ({_GRID_YZ})")
    if h0 is None:
        h0 = torch.zeros(B, W, dtype=torch.float32, device=log_a.device)
    elif h0.device != log_a.device:
        raise ValueError(f"h0 is on {h0.device}, log_a on {log_a.device}")
    log_a, b = log_a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty_like(log_a)
    h_last = torch.empty(B, W, dtype=torch.float32, device=log_a.device)
    if B == 0 or W == 0:
        return out, h_last
    bf16 = log_a.dtype == torch.bfloat16
    fn_name = "rglru_scan_bf16" if bf16 else "rglru_scan_f32"
    lib = _lib("rglru_scan", [(n, [_VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _VP])
                              for n in ("rglru_scan_f32", "rglru_scan_bf16")])
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        err = getattr(lib, fn_name)(log_a.data_ptr(), b.data_ptr(),
                                    h0.data_ptr(), out.data_ptr(),
                                    h_last.data_ptr(), B, T, W, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return out, h_last


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _rglru_scan_vjp(log_a, b, h0, g_h, g_last):
    """The VJP of the plain scan at (log_a, b, h0) → (d log_a, db, dh0 or
    None): autograd's own steps, the CPU's backward."""
    if h0 is None:
        _, pull = torch.func.vjp(ref.rglru_scan_reference, log_a, b)
        return (*pull((g_h, g_last)), None)
    _, pull = torch.func.vjp(ref.rglru_scan_reference, log_a, b, h0)
    return pull((g_h, g_last))


class _RglruScan(torch.autograd.Function):
    """B3; its backward by device (see the module docstring)."""

    @staticmethod
    def forward(log_a, b, h0):
        return _rglru_scan_forward(log_a, b, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        # B3′ reads the carry from an f32 output h; a bf16 one is not the
        # carry, and the CPU's plain VJP recomputes it: neither is kept
        h = output[0]
        keep = h.dtype == torch.float32 and h.device.type != "cpu"
        ctx.save_for_backward(*inputs, h if keep else None)

    @staticmethod
    def backward(ctx, g_h, g_last):
        log_a, b, h0, h = ctx.saved_tensors
        if _on_cpu(log_a, b, h0):
            return _rglru_scan_vjp(log_a, b, h0, g_h, g_last)
        return rglru_scan_backward(log_a, b, h0, h, g_h, g_last)

    @staticmethod
    def vmap(info, in_dims, log_a, b, h0):
        V = info.batch_size
        log_a, b = (_fold(t, d, V) for t, d in zip((log_a, b), in_dims[:2]))
        h0 = None if h0 is None else _fold(h0, in_dims[2], V)
        h, last = _RglruScan.apply(log_a, b, h0)
        return (h.unflatten(0, (V, -1)), last.unflatten(0, (V, -1))), (0, 0)


def rglru_scan(log_a, b, h0=None):
    """Linear recurrence h_t = exp(log_a_t)·h_{t-1} + b_t over (B, T, W),
    carry in f32. log_a, b (B, T, W) f32/bf16; h0 (B, W) or None (zeros)
    → (h (B, T, W) in log_a's dtype, h_last (B, W) f32). Differentiable:
    on the card through B3′ (:func:`rglru_scan_backward`)."""
    _check_dtype(log_a, b)
    if log_a.shape != b.shape or log_a.ndim != 3:
        raise ValueError(f"bad shapes {tuple(log_a.shape)} {tuple(b.shape)}")
    B, T, W = log_a.shape
    if T < 1:
        raise ValueError("rglru_scan needs T >= 1")
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} does not match {(B, W)}")
    return _RglruScan.apply(log_a, b, h0)


rglru_scan.launches = 0


#: B3′'s launch constants: channels a CTA owns and steps a chunk holds
#: (``kBwdCh``, ``kBwdSteps`` of ``csrc/rglru_scan.cu``, which refuses any
#: other plan), and the cluster size asked for (8, the portable most)
B3P_CH, B3P_STEPS, B3P_CLUSTER = 64, 64, 8
#: the most CTAs a cluster may hold (above 8 the kernel sets the
#: non-portable attribute) and the dynamic shared memory a block may have
#: on the H100
_CLUSTER_MAX, _SMEM_MAX = 16, 232_448


class B3pPlan(NamedTuple):
    """B3′'s launch at one shape: ``ch`` channels a CTA, time cut into
    ``chunks`` chunks of ``steps`` steps, a cluster of ``cluster`` CTAs
    along grid z whose rank s owns chunks s, s + cluster, ... (``laps``
    of them at most), ``smem`` bytes of dynamic shared memory a CTA, and
    the f32 entry-carry scratch's shape, or None where none is needed."""
    ch: int
    steps: int
    cluster: int
    chunks: int
    laps: int
    grid: Tuple[int, int, int]
    smem: int
    scratch: Optional[Tuple[int, int, int]]

    def ring(self, rank: int):
        """The chunks CTA ``rank`` of a cluster owns, in lap order."""
        return list(range(rank, self.chunks, self.cluster))


def _rglru_scan_backward_plan(B, T, W, elem, has_h, *, ch=None, steps=None,
                              cluster=None) -> B3pPlan:
    """B3′'s launch plan for (B, T, W) of ``elem``-byte inputs; ``has_h``:
    the f32 saved output is read as the carry (else the kernel recomputes
    it). ``ch``, ``steps`` and ``cluster`` default to the module's B3P_*
    constants. Raises by name where the shape cannot be launched."""
    ch = B3P_CH if ch is None else ch
    steps = B3P_STEPS if steps is None else steps
    cluster = B3P_CLUSTER if cluster is None else cluster
    if min(B, T, W) < 1:
        raise ValueError(f"B3′ needs B, T, W >= 1, got {(B, T, W)}")
    if B > _GRID_YZ:
        raise ValueError(f"B={B} exceeds the kernel's grid ({_GRID_YZ})")
    if T >= _INT_MAX or W >= _INT_MAX:
        raise ValueError(f"T={T} or W={W} exceeds the tensor maps' int "
                         "coordinates")
    if not 1 <= cluster <= _CLUSTER_MAX:
        raise ValueError(f"cluster {cluster} is outside 1..{_CLUSTER_MAX}")
    chunks = -(-T // steps)
    cluster = min(cluster, chunks)
    laps = -(-chunks // cluster)
    recompute = not (has_h and elem == 4)
    head = -(-(4 * 8 + 3 * 4 * ch) // 128) * 128
    smem = head + (2 if laps > 1 else 1) * 3 * steps * ch * elem
    if smem > _SMEM_MAX:
        raise ValueError(f"B3′ needs {smem} bytes of shared memory a CTA "
                         f"(the card has {_SMEM_MAX})")
    return B3pPlan(ch, steps, cluster, chunks, laps,
                   (-(-W // ch), B, cluster), smem,
                   (B, chunks, W) if recompute and laps > 1 else None)


def _rglru_scan_backward_launch(log_a, b, h0, h, g_h, g_last):
    """B3′'s dispatch by device → (d log_a, db, dh0 f32): the plain
    backward on the CPU, the kernel on the card (shapes already checked;
    ``h0`` and ``g_last`` may be None)."""
    B, T, W = log_a.shape
    if _on_cpu(log_a, b, h0, h, g_h, g_last):
        return ref.rglru_scan_backward_reference(log_a, b, h0, h, g_h,
                                                 g_last)
    dh0 = torch.empty(B, W, dtype=torch.float32, device=log_a.device)
    if _on_meta(log_a, b, g_h):
        work.add("rglru_scan_backward", work.rglru_scan_backward(
            B, T, W, with_h0=h0 is not None, with_g_last=g_last is not None,
            elem=log_a.element_size()))
        return torch.empty_like(log_a), torch.empty_like(b), dh0
    _cuda_only(log_a, b, g_h, *(() if h is None else (h,)))
    for name, t in (("h0", h0), ("g_last", g_last)):
        if t is not None and t.device != log_a.device:
            raise ValueError(f"{name} is on {t.device}, log_a on "
                             f"{log_a.device}")
    log_a, b, g_h = (t.contiguous() for t in (log_a, b, g_h))
    h0, g_last = (None if t is None else t.to(torch.float32).contiguous()
                  for t in (h0, g_last))
    # the kernel reads the carry from an f32 output
    h = h.contiguous() if h is not None and h.dtype == torch.float32 \
        else None
    dla, db = torch.empty_like(log_a), torch.empty_like(b)
    if B == 0 or W == 0:
        return dla, db, dh0
    bf16 = log_a.dtype == torch.bfloat16
    plan = _rglru_scan_backward_plan(B, T, W, log_a.element_size(),
                                     h is not None)
    # where the carry is recomputed over more than one lap of the cluster,
    # each chunk's entry carry is kept here between the two walks
    entry = (None if plan.scratch is None else torch.empty(
        plan.scratch, dtype=torch.float32, device=log_a.device))
    fn_name = "rglru_scan_bwd_bf16" if bf16 else "rglru_scan_bwd_f32"
    lib = _lib("rglru_scan", [(n, [_VP] * 10 + [_LL] * 3 + [_I] * 4 + [_VP])
                              for n in ("rglru_scan_bwd_f32",
                                        "rglru_scan_bwd_bf16")])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        err = getattr(lib, fn_name)(
            log_a.data_ptr(), b.data_ptr(), ptr(h0), ptr(h),
            g_h.data_ptr(), ptr(g_last), dla.data_ptr(), db.data_ptr(),
            dh0.data_ptr(), ptr(entry), B, T, W, plan.ch, plan.steps,
            plan.cluster, plan.smem, stream)
    if err == -2:
        raise RuntimeError(f"{fn_name} refused the plan {plan}: not the "
                           "built kernel's constants")
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    rglru_scan_backward.launches += 1
    return dla, db, dh0


class _RglruScanBackward(torch.autograd.Function):
    """B3′: the scan's VJP as one kernel; its own backward is the VJP of
    the plain version's VJP (a second derivative of the plain version)."""

    @staticmethod
    def forward(log_a, b, h0, h, g_h, g_last):
        return _rglru_scan_backward_launch(log_a, b, h0, h, g_h, g_last)

    @staticmethod
    def setup_context(ctx, inputs, output):
        log_a, b, h0, _, g_h, g_last = inputs
        ctx.save_for_backward(log_a, b, h0, g_h, g_last)

    @staticmethod
    def backward(ctx, gg_la, gg_b, gg_h0):
        log_a, b, h0, g_h, g_last = ctx.saved_tensors
        no_last = g_last is None
        if no_last:
            g_last = torch.zeros(log_a.shape[0], log_a.shape[2],
                                 dtype=torch.float32, device=log_a.device)
        primals = [t for t in (log_a, b, h0) if t is not None]
        n = len(primals)

        def vjp(*args):
            la, bb, *rest = args
            hh = rest[0] if n == 3 else None
            return tuple(x for x in _rglru_scan_vjp(la, bb, hh, *args[n:])
                         if x is not None)

        cot = (gg_la, gg_b, gg_h0.to(h0.dtype)) if n == 3 else (gg_la, gg_b)
        _, pull = torch.func.vjp(vjp, *primals, g_h, g_last)
        d = list(pull(cot))
        d_h0 = d.pop(2) if n == 3 else None
        return d[0], d[1], d_h0, None, d[2], None if no_last else d[3]

    @staticmethod
    def vmap(info, in_dims, log_a, b, h0, h, g_h, g_last):
        V = info.batch_size
        ins = [None if t is None else _fold(t, d, V) for t, d in
               zip((log_a, b, h0, h, g_h, g_last), in_dims)]
        out = _RglruScanBackward.apply(*ins)
        return tuple(o.unflatten(0, (V, -1)) for o in out), (0, 0, 0)


def rglru_scan_backward(log_a, b, h0, h, g_h, g_last=None):
    """B3′, the scan's vector-Jacobian product (the plain version:
    :func:`ref.rglru_scan_backward_reference`): log_a, b (B, T, W) f32 /
    bf16 of one dtype, h0 (B, W) or None, h the forward's output (B, T, W)
    or None (read as the carry when f32; else the kernel recomputes the
    carry), g_h its cotangent, g_last (B, W) that of h_last or None →
    (d log_a, db in their dtypes, dh0 in h0's dtype, or None without h0)."""
    _check_dtype(log_a, b)
    if log_a.ndim != 3 or any(tuple(t.shape) != tuple(log_a.shape)
                              for t in (b, g_h) + (() if h is None else (h,))):
        raise ValueError(f"bad shapes log_a {tuple(log_a.shape)}, b "
                         f"{tuple(b.shape)}, h "
                         f"{None if h is None else tuple(h.shape)}, g_h "
                         f"{tuple(g_h.shape)}: want (B, T, W) each")
    B, T, W = log_a.shape
    for name, t in (("h0", h0), ("g_last", g_last)):
        if t is not None and tuple(t.shape) != (B, W):
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"{(B, W)}")
    dla, db, dh0 = _RglruScanBackward.apply(log_a, b, h0, h, g_h, g_last)
    return dla, db, None if h0 is None else dh0.to(h0.dtype)


rglru_scan_backward.launches = 0


def _kernel_layout(t):
    """``t`` itself when the kernel can read it with 16-byte loads (f32)
    or TMA boxes (bf16): unit head_dim stride, the other strides positive
    multiples of 16 bytes, 16-byte aligned base; else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st > 0 and st * t.element_size() % 16 == 0
                  for st in t.stride()[:-1]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _flash_attention_forward(q, k, v, causal, window, softcap):
    """The attention's dispatch by device: the plain version on the CPU,
    the kernel on the card (shapes already checked)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention_reference(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if _on_meta(q, k, v):
        work.add("flash_attention", work.flash_attention(
            B, S, T, H, K, hd, causal=causal, window=window,
            elem=q.element_size()))
        return torch.empty(B, S, H, hd, dtype=q.dtype, device="meta")
    _cuda_only(q, k, v)
    if hd > 256 or hd % 4:
        raise ValueError(f"head_dim={hd}: the kernel takes head_dim <= 256 "
                         "and a multiple of 4")
    if B > _GRID_YZ or H > _GRID_YZ or -(-S // 128) > _GRID_YZ \
            or max(S, T) > _INT_MAX // 2 or window > _INT_MAX:
        raise ValueError(f"B={B}, H={H}, S={S}, T={T} or window={window} "
                         "exceeds the kernel's grid or int positions")
    out = torch.empty(B, S, H, hd, dtype=q.dtype, device=q.device)
    if B == 0 or S == 0 or H == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention needs T >= 1")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and hd % 8:
        # TMA rows are 16-byte multiples: pad head_dim with zero columns
        # (zero q/k terms, v columns the kernel does not store)
        q, k, v = (torch.nn.functional.pad(t, (0, 8 - hd % 8))
                   for t in (q, k, v))
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
            H, K, hd]
    if bf16:
        fn_name = "flash_attention_bf16"
        args.append(q.shape[-1])
    else:
        fn_name = "flash_attention_f32"
    lib = _lib("flash_attention", [
        ("flash_attention_f32", [_VP] * 4 + [_LL] * 6 + [_PLL, _I, _I, _F, _F,
                                                          _VP]),
        ("flash_attention_bf16", [_VP] * 4 + [_LL] * 7 + [_PLL, _I, _I, _F,
                                                           _F, _VP])])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            *args, strides, int(bool(causal)), max(int(window), 0),
            float(softcap), scale, stream)
    if err == -1:
        raise RuntimeError(
            f"{fn_name}: the driver refused a TMA tensor map for q, k, v of "
            f"shapes {[tuple(t.shape) for t in (q, k, v)]}, strides "
            f"{list(strides)}")
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def _flash_attention_vjp(q, k, v, g, causal, window, softcap):
    """The VJP of the plain attention at (q, k, v) → (dq, dk, dv):
    autograd's own steps, the CPU's backward."""
    _, pull = torch.func.vjp(
        lambda q, k, v: ref.attention_reference(
            q, k, v, causal=causal, window=window, softcap=softcap),
        q, k, v)
    return pull(g)


class _FlashAttention(torch.autograd.Function):
    """B4; its backward by device (see the module docstring)."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap):
        return _flash_attention_forward(q, k, v, causal, window, softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3])
        ctx.mask = inputs[3:]

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if _on_cpu(q, k, v, g):
            return (*_flash_attention_vjp(q, k, v, g, *ctx.mask), None,
                    None, None)
        causal, window, softcap = ctx.mask
        return (*flash_attention_backward(q, k, v, g, causal=causal,
                                          window=window, softcap=softcap),
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap):
        V = info.batch_size
        q, k, v = (_fold(t, d, V) for t, d in zip((q, k, v), in_dims[:3]))
        out = _FlashAttention.apply(q, k, v, causal, window, softcap)
        return out.unflatten(0, (V, -1)), 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Exact GQA/MQA attention with positions from 0: q (B, S, H, hd);
    k, v (B, T, K, hd), H % K == 0 (q head h reads kv head h // (H/K));
    causal and sliding-window (``window`` > 0) masks, tanh soft-capping of
    the scores (``softcap`` > 0) → (B, S, H, hd) in q's dtype.
    Differentiable: on the card through B4′
    (:func:`flash_attention_backward`)."""
    _check_dtype(q, k, v)
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[3] != k.shape[3] or q.shape[0] != k.shape[0]:
        raise ValueError(f"bad shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} not a multiple of K={k.shape[2]}")
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(softcap))


flash_attention.launches = 0


#: blocks of B4′'s dk/dv grid below which it splits each kv head's query
#: heads over several blocks (two waves of the H100's 132 SMs)
_BWD_MIN_BLOCKS = 264


def _bwd_head_splits(B: int, T: int, K: int, group: int,
                     tile: int = 64) -> int:
    """How many blocks share one (kv tile of ``tile`` keys, kv head, batch
    row)'s query heads in B4′'s dk/dv pass: 1 where the kv tiles alone
    fill the card, else enough to reach ``_BWD_MIN_BLOCKS`` (at most
    ``group``, and within the grid's z limit)."""
    blocks = -(-T // tile) * K * B
    if blocks >= _BWD_MIN_BLOCKS:
        return 1
    per = -(-group // min(group, -(-_BWD_MIN_BLOCKS // blocks)))
    splits = -(-group // per)
    return max(1, min(splits, _GRID_YZ // max(B, 1)))


def _bwd_key_tile(dtype, hd: int) -> int:
    """Keys a block of B4′'s dk/dv pass holds: 64 on the f32 SIMT kernel;
    on the bf16 tensor-core kernel 64 a consumer warpgroup, two of them,
    or 64 in all at head_dim > 128 (the consumers split head_dim)."""
    if dtype != torch.bfloat16:
        return 64
    return 64 if hd > 128 else 128


def _flash_attention_backward_launch(q, k, v, g, causal, window, softcap):
    """B4′'s dispatch by device → (dq, dk, dv): the plain backward on the
    CPU, the kernel on the card (shapes already checked)."""
    if _on_cpu(q, k, v, g):
        return ref.attention_backward_reference(
            q, k, v, g, causal=causal, window=window, softcap=softcap)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if _on_meta(q, k, v, g):
        work.add("flash_attention_backward", work.flash_attention_backward(
            B, S, T, H, K, hd, causal=causal, window=window,
            elem=q.element_size()))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _cuda_only(q, k, v, g)
    if hd > 256:
        raise ValueError(f"head_dim={hd}: the backward kernel takes "
                         "head_dim <= 256")
    if B > _GRID_YZ or max(H, K) > _GRID_YZ or max(S, T) > _INT_MAX // 2 \
            or window > _INT_MAX:
        raise ValueError(f"B={B}, H={H}, K={K}, S={S}, T={T} or "
                         f"window={window} exceeds the backward kernel's "
                         "grid or int positions")
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B == 0 or S == 0 or H == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    bf16 = q.dtype == torch.bfloat16
    # dk, dv as f32 sums of each block's share of the q heads, added in
    # order and rounded once
    splits = _bwd_head_splits(B, T, K, H // K, _bwd_key_tile(q.dtype, hd))
    partial = torch.empty(2, splits, B, T, K, hd, dtype=torch.float32,
                          device=q.device)
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    mask = (int(bool(causal)), max(int(window), 0), float(softcap), scale)
    if bf16:
        # TMA rows are 16-byte multiples: head_dim padded with zero
        # columns (zero terms; dq, dk, dv keep hd); each row's lse and D
        # padded to whole 64-row tiles; q_scaled for the dk/dv grid
        if hd % 8:
            q, k, v, g = (torch.nn.functional.pad(t, (0, 8 - hd % 8))
                          for t in (q, k, v, g))
        q, k, v, g = (_kernel_layout(t) for t in (q, k, v, g))
        hd_in = q.shape[-1]
        stats = torch.empty(2, B, H, -(-S // 64) * 64, dtype=torch.float32,
                            device=q.device)
        qs = torch.empty(B, S, H, hd_in, dtype=q.dtype, device=q.device)
        fn_name = "flash_attention_bwd_bf16"
        args = (q, k, v, g, qs, dq, dk, dv, stats, partial, B, S, T, H, K,
                hd, hd_in, splits)
    else:
        # each query row's log-sum-exp and D = Σ_t P_t dP_t, written by
        # the dq pass and read by the dk/dv pass
        stats = torch.empty(2, B, H, S, dtype=torch.float32,
                            device=q.device)
        fn_name = "flash_attention_bwd_f32"
        args = (q, k, v, g, dq, dk, dv, stats, partial, B, S, T, H, K, hd,
                splits)
    lib = _lib("flash_attention_bwd", [
        ("flash_attention_bwd_f32", [_VP] * 9 + [_LL] * 7 + [_I, _I, _F, _F,
                                                              _VP]),
        ("flash_attention_bwd_bf16", [_VP] * 10 + [_LL] * 8 + [_I, _I, _F,
                                                                _F, _VP])])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
            *mask, stream)
    if err == -1:
        raise RuntimeError(
            f"{fn_name}: the driver refused a TMA tensor map for q, k, v, g "
            f"of shapes {[tuple(t.shape) for t in (q, k, v, g)]}")
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


class _FlashAttentionBackward(torch.autograd.Function):
    """B4′: the attention's VJP as one kernel launch; its own backward is
    the VJP of the plain version's VJP (a second derivative of the plain
    version)."""

    @staticmethod
    def forward(q, k, v, g, causal, window, softcap):
        return _flash_attention_backward_launch(q, k, v, g, causal, window,
                                                softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:4])
        ctx.mask = inputs[4:]

    @staticmethod
    def backward(ctx, gg_q, gg_k, gg_v):
        mask = ctx.mask
        _, pull = torch.func.vjp(
            lambda q, k, v, g: _flash_attention_vjp(q, k, v, g, *mask),
            *ctx.saved_tensors)
        return (*pull((gg_q, gg_k, gg_v)), None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, g, causal, window, softcap):
        V = info.batch_size
        q, k, v, g = (_fold(t, d, V) for t, d in zip((q, k, v, g),
                                                      in_dims[:4]))
        out = _FlashAttentionBackward.apply(q, k, v, g, causal, window,
                                            softcap)
        return tuple(o.unflatten(0, (V, -1)) for o in out), (0, 0, 0)


def flash_attention_backward(q, k, v, g, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """B4′, the attention's vector-Jacobian product (the plain version:
    :func:`ref.attention_backward_reference`): q (B, S, H, hd), k, v (B,
    T, K, hd) of one dtype, g (B, S, H, hd) the cotangent of the output,
    the masks and softcap of :func:`flash_attention` → (dq, dk, dv) in
    their inputs' dtypes. The kernel recomputes the scores and each row's
    log-sum-exp (the forward writes nothing for it) and uses no atomics:
    two launches on the same inputs give the same bits."""
    _check_dtype(q, k, v, g)
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[3] != k.shape[3] or q.shape[0] != k.shape[0] \
            or g.shape != q.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}"
                         f" v {tuple(v.shape)} g {tuple(g.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} not a multiple of K={k.shape[2]}")
    return _FlashAttentionBackward.apply(q, k, v, g, bool(causal),
                                         int(window), float(softcap))


flash_attention_backward.launches = 0
