"""ConsensusEngine — the single entry point for one Eq.-(6) mixing round.

A ``(Topology, K, codec)`` description resolves ONCE, at construction,
into an execution plan, and every caller drives the same
``engine.step(stacked_params, codec_state, generator) -> (params,
codec_state)``.

Plans
-----
* ``dense``  — the reference (K, K) matmul per leaf.
* ``sparse`` — one launch per leaf of the population-level consensus
  kernels (:mod:`repro_torch.kernels.ops`): each agent gathers its H
  neighbour rows from the (K, N) stack, O(K·H·N) instead of O(K²·N).
  Int wires stay int8 lanes into the fused dequantizing kernel.

The JAX package's plan names ``dense-xla`` and ``sparse-pallas`` are
accepted as aliases. ``plan="auto"`` uses the payload-aware density
heuristic :func:`repro_torch.core.consensus.auto_path`.

Every compressed plan recentres each agent on its OWN decoded copy
(CHOCO), so under doubly-stochastic σ the population mean is exact
whatever the codec.

This slice runs lockstep rounds on static graphs on one device: a mesh
(the sharded and distributed plans), a time-varying graph process, and
per-agent availability (``agents=`` / ``tau=``) are refused.
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import consensus

PLAN_KINDS = ("dense", "sparse")
PLAN_ALIASES = {"dense-xla": "dense", "sparse-pallas": "sparse"}
_LATER = "a later slice of the port"


@dataclass(frozen=True)
class ExecutionPlan:
    """A resolved consensus execution strategy (see module docstring)."""

    kind: str
    reason: str

    def __post_init__(self):
        if self.kind not in PLAN_KINDS:
            names = PLAN_KINDS + tuple(PLAN_ALIASES) + ("auto",)
            close = difflib.get_close_matches(str(self.kind), names, n=1)
            hint = f"; did you mean {close[0]!r}?" if close else ""
            raise ValueError(f"unknown plan {self.kind!r}; choose from "
                             f"{names}{hint}")


class ConsensusEngine:
    """One Eq.-(6) round behind one entry point (see module docstring).

    topology:   a :class:`repro_torch.core.topology.Topology` (also
                enables :meth:`round_comm_joules`) or a concrete (K, K) σ.
    codec:      exchange codec spec/Codec; lossy codecs get error
                feedback unless ``error_feedback=False``.
    plan:       "auto", one of :data:`PLAN_KINDS`, or a JAX plan alias.
    data_sizes / mix_kind / include_self: forwarded to ``mixing``.
    gamma:      CHOCO consensus step size (damps off-diagonal σ).
    """

    def __init__(self, topology, *, codec=None, mesh=None,
                 plan: str = "auto", data_sizes=None,
                 mix_kind: str = "paper", include_self: bool = True,
                 gamma: float = 1.0, error_feedback: bool = True,
                 graph=None, agents=None, tau=None):
        from repro_torch.comms import codecs
        if isinstance(topology, ConsensusEngine):
            raise TypeError(
                f"topology= got an already-built ConsensusEngine "
                f"(plan={topology.plan.kind!r}); pass a Topology or mix "
                "matrix, or coerce with ConsensusEngine.wrap(engine)")
        if mesh is not None:
            raise ValueError(
                f"mesh={mesh!r}: the sharded and distributed plans come in "
                f"{_LATER}; drop mesh= to run the population on one device")
        if graph is not None and getattr(graph, "kind", None) != "static":
            raise ValueError(
                f"graph={graph!r}: time-varying graph processes come in "
                f"{_LATER}; pass graph=None for a static graph")
        if agents is not None or tau is not None:
            raise ValueError(
                f"agents={agents!r} / tau={tau!r}: asynchronous consensus "
                f"comes in {_LATER}; drop both for lockstep rounds")
        if mix_kind not in consensus.MIX_KINDS:
            raise ValueError(consensus._unknown_kind_msg(mix_kind))
        self.topology = topology if hasattr(topology, "mixing") else None
        self.mix = np.asarray(
            topology.mixing(data_sizes, kind=mix_kind,
                            include_self=include_self)
            if self.topology is not None else topology, np.float32)
        if self.mix.ndim != 2 or self.mix.shape[0] != self.mix.shape[1]:
            raise ValueError(f"mix must be (K, K), got {self.mix.shape}")
        self.K = self.mix.shape[0]
        self.codec = codecs.resolve_codec(codec, error_feedback)
        self.gamma = float(gamma)
        self.plan = self._resolve_plan(plan)
        self._structure_np = None
        self._structure_dev = {}

    # -- plan selection ---------------------------------------------------------
    def _resolve_plan(self, plan: str) -> ExecutionPlan:
        if plan == "auto":
            base = getattr(self.codec, "inner", self.codec)
            kind = consensus.auto_path(self.mix, codec=base)
            return ExecutionPlan(
                kind, f"payload-aware density heuristic (max degree vs "
                f"K={self.K})")
        return ExecutionPlan(PLAN_ALIASES.get(plan, plan), "explicit")

    # -- state ------------------------------------------------------------------
    def init_state(self, stacked_params):
        """Initial codec state (stacked EF residuals; None if stateless)."""
        if self.codec is None or not self.codec.stateful:
            return None
        return self.codec.init_state(stacked_params)

    def sparse_structure(self, device):
        """(idx, sig) neighbour-lane tables of the sparse plan on
        ``device``, built once from the mix (indices checked in range)."""
        if self._structure_np is None:
            idx, sig = consensus.sparse_structure(self.mix)
            if idx.size and (idx.min() < 0 or idx.max() >= self.K):
                raise ValueError(f"neighbour index out of [0, {self.K})")
            self._structure_np = (idx, sig)
        key = str(torch.device(device))
        if key not in self._structure_dev:
            idx, sig = self._structure_np
            self._structure_dev[key] = (
                torch.as_tensor(idx, device=device),
                torch.as_tensor(sig, device=device))
        return self._structure_dev[key]

    # -- the round --------------------------------------------------------------
    def step(self, stacked_params, codec_state=None, generator=None):
        """One Eq.-(6) round on agent-stacked params (a dict of (K, ...)
        tensors). Returns ``(params, codec_state)`` for every plan and
        codec (state None for codec-free rounds). ``generator`` enables
        stochastic rounding for quantizing codecs."""
        kind = self.plan.kind
        structure = None
        if kind == "sparse":
            structure = self.sparse_structure(
                next(iter(stacked_params.values())).device)
        if self.codec is None:
            return consensus.consensus_step(
                stacked_params, self.mix, impl=kind,
                structure=structure), None
        # error_feedback=False: self.codec is already resolved
        return consensus.consensus_step(
            stacked_params, self.mix, impl=kind, codec=self.codec,
            codec_state=codec_state, generator=generator, gamma=self.gamma,
            error_feedback=False, structure=structure)

    # -- Eq.-(11) pricing -------------------------------------------------------
    def round_comm_joules(self, energy_params, model_bits=None) -> float:
        """Eq.-(11) communication energy of ONE round at this engine's
        wire format (the topology's codec-aware pricing)."""
        if self.topology is None:
            raise ValueError(
                f"this {self.plan.kind!r} engine was built from a raw "
                f"{self.mix.shape} mix matrix, which carries no link "
                "classes to bill; construct it from a Topology")
        return self.topology.round_comm_joules(
            energy_params, model_bits=model_bits, codec=self.codec)

    @classmethod
    def wrap(cls, obj, **kw) -> "ConsensusEngine":
        """Coerce ``obj`` (engine, Topology, or mix) to an engine; extra
        kwargs only apply when constructing a new one."""
        if isinstance(obj, cls):
            if any(v is not None for v in kw.values()):
                raise ValueError(
                    f"{sorted(k for k, v in kw.items() if v is not None)} "
                    "cannot be re-specified for an existing engine")
            return obj
        return cls(obj, **kw)

    def __repr__(self):
        codec = self.codec.name if self.codec is not None else None
        return (f"ConsensusEngine(K={self.K}, plan={self.plan.kind!r}, "
                f"codec={codec!r})")
