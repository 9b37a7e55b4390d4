"""Analytic cross-checks of the counted xLSTM FLOPs: the port's
counterpart of the JAX package's ``launch/probes.py``.

The JAX package's XLA cost analysis counts a ``while`` body once, so its
dry run lowers 1- and 2-layer unrolled probes (``probe_configs``) and
extrapolates (``corrected``), and adds the xLSTM's inner time scans
analytically. The port's dry run (:mod:`repro_torch.launch.dryrun`) runs
the step eagerly on ``meta`` tensors and counts every op it dispatches,
every layer and time step included, so ``probe_configs`` and
``corrected`` have no counterpart, by design. What stays are the
analytic terms, as cross-checks of what the eager count sees: the sLSTM's
recurrent matmuls and the mLSTM's chunkwise cell, the same formulas as
the reference's.
"""
from __future__ import annotations


def slstm_recurrent_flops(cfg, shape, chips: int) -> float:
    """Per-device analytic FLOPs of the sLSTM time-scan recurrent matmuls
    (4 gates × blockdiag (H, hd, hd) per step), fwd (+2x for train bwd)."""
    if cfg.family != "ssm":
        return 0.0
    n_slstm = len(cfg.xlstm.slstm_at)
    H = cfg.num_heads
    hd = cfg.d_model // H
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.mode == "train" else
                                   (shape.seq_len if shape.mode == "prefill"
                                    else 1))
    per_tok = 4 * H * hd * hd * 2            # 4 gate matmuls, 2 flops/MAC
    mult = 3.0 if shape.mode == "train" else 1.0
    return n_slstm * tokens * per_tok * mult / chips


def mlstm_intra_flops(cfg, shape, chunk: int = 256) -> float:
    """Analytic FLOPs of the mLSTM chunkwise cell (intra-chunk quadratic +
    carry updates), GLOBAL, fwd (+2x bwd for train), times (nc − 1)/nc:
    the share the JAX package's cost analysis misses (it counts the chunk
    scan's body once)."""
    if cfg.family != "ssm":
        return 0.0
    T = shape.seq_len if shape.mode in ("train", "prefill") else 1
    if T <= chunk:
        return 0.0
    B = shape.global_batch
    H = cfg.num_heads
    pdim = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    phd = pdim // H
    n_mlstm = cfg.num_layers - len(cfg.xlstm.slstm_at)
    nc = -(-T // chunk)
    per_chunk = (2 * chunk * chunk * phd * 2     # S = qk^T, num = S@v
                 + 2 * chunk * phd * phd * 2)    # carry C/n updates
    total = B * H * n_mlstm * nc * per_chunk
    mult = 3.0 if shape.mode == "train" else 1.0
    return total * mult * (nc - 1) / nc


def ssm_analytic_correction(cfg, shape) -> float:
    """Global FLOPs the JAX package's raw cost analysis misses for the ssm
    family (its sLSTM scan and the mLSTM chunk scan beyond the first
    chunk); in the port's eager count they are already counted."""
    return (slstm_recurrent_flops(cfg, shape, 1)
            + mlstm_intra_flops(cfg, shape))
