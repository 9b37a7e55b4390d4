"""Adaptive codec selection from link quality — the "auto" wire format:
the port of the JAX package's ``comms/select.py``.

The Eq.-(11) cost of a consensus round is (wire bits) × (J/bit of the
links that carry them), so the right compression level is a function of
link EFFICIENCY: on cheap links (high bit/J) a wide wire costs little and
keeps the quantization error floor low; on expensive links the bits
dominate the energy balance and a narrow wire wins even after paying the
extra rounds the compression error induces (Elgabli et al.,
arXiv:2105.14772 make the same tradeoff the optimization variable).

``select_codec`` inspects the topology's link classes (and any per-edge
``edge_efficiency`` overrides) against two thresholds and picks the wire
for the WORST link the round has to cross — the graph's bottleneck link
sets the energy bill, so it sets the codec:

    eff >= bf16_min_bit_per_joule   ->  bf16   (cheap links, wide wire)
    eff >= int8_min_bit_per_joule   ->  int8
    otherwise                       ->  int4   (expensive links)

``train_federated(codec="auto")`` routes through this helper.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.comms.codecs import Codec, resolve_codec

#: bit/J thresholds: the paper-calibrated sidelink (4e6 bit/J) affords
#: bf16; its uplink/downlink (1.6e6) and Table I's raw 500 kbit/J land on
#: int8; an order-of-magnitude degraded link (< 0.5e6) drops to int4.
BF16_MIN_BIT_PER_JOULE = 2e6
INT8_MIN_BIT_PER_JOULE = 0.5e6


def link_efficiencies(topology, link_quality=None) -> dict:
    """bit/J of every link class PRESENT in ``topology`` (keyed SL/UL/DL),
    plus per-edge overrides' worst case under ``"edge"`` when set.

    ``link_quality``: an :class:`repro_torch.core.energy.EnergyParams` (its
    E_SL/E_UL/E_DL, honouring the UL+γ·DL sidelink replacement), a dict
    ``{"SL": bit_per_joule, ...}``, or None for the paper calibration.
    """
    from repro_torch.core import energy
    from repro_torch.core.topology import LINK_CLASS_NAMES

    if link_quality is None:
        link_quality = energy.paper_calibrated("fig3")
    if isinstance(link_quality, dict):
        effs = dict(link_quality)
    else:
        p = link_quality
        effs = {"SL": 1.0 / energy.sidelink_cost_per_bit(p),
                "UL": p.E_UL, "DL": p.E_DL}
    # class constants only price edges WITHOUT a per-edge override (the
    # fallback rule of round_comm_joules): a class whose every edge is
    # overridden does not enter the bottleneck
    eff_mat = getattr(topology, "edge_efficiency", None)
    unset = (topology.adjacency if eff_mat is None
             else topology.adjacency & ~(eff_mat > 0))
    out = {}
    for cls_id, name in LINK_CLASS_NAMES.items():
        if not ((topology.link_class == cls_id) & unset).any():
            continue
        if name not in effs:
            raise ValueError(
                f"link_quality is missing an efficiency for class "
                f"{name!r}, which {topology.name!r} has links in")
        out[name] = effs[name]
    if eff_mat is not None:
        per_edge = eff_mat[topology.adjacency]
        per_edge = per_edge[per_edge > 0]
        if per_edge.size:
            out["edge"] = float(per_edge.min())
    return out


def select_codec(topology, link_quality=None, *,
                 error_feedback: bool = True,
                 bf16_min_bit_per_joule: float = BF16_MIN_BIT_PER_JOULE,
                 int8_min_bit_per_joule: float = INT8_MIN_BIT_PER_JOULE,
                 ) -> Optional[Codec]:
    """Pick the wire format for ``topology`` from its bottleneck link
    efficiency (see module docstring). Returns a resolved Codec (lossy
    picks carry the error-feedback wrapper unless disabled)."""
    effs = link_efficiencies(topology, link_quality)
    if not effs:                      # edgeless graph: nothing on the wire
        return None
    worst = min(effs.values())
    if worst >= bf16_min_bit_per_joule:
        spec = "bf16"
    elif worst >= int8_min_bit_per_joule:
        spec = "int8"
    else:
        spec = "int4"
    return resolve_codec(spec, error_feedback)
