"""End-to-end energy & communication footprint model — paper Eqs. (8)–(12).

Stage 1 (MAML at the data center), Eq. (8)–(9):
    E_ML(t0, Q) = E_ML^L(t0, Q) + E_ML^C(Q)
    E_ML^L = γ · t0 · Σ_{i≤Q} Σ_{k∈C_i} [B_a + β·B_b] · E0^C
    E_ML^C = t0 · Σ_{i≤Q} Σ_{k∈C_i} b(E_ik)/E_UL  +  Σ_{k≤K} b(W)/E_DL

Stage 2 (per-task FL adaptation), Eq. (10)–(11):
    E_FL(t_i) = t_i · Σ_{k∈C_i} B_i · E_k^C
              + b(W) · t_i · Σ_{k∈C_i} Σ_{h∈N_ki} 1/E_SL

Total (Eq. 12):  E = E_ML(t0, Q) + Σ_{i≤M} E_FL(t_i)

Efficiencies are in bit/J, computing in grad/J (Sect. III-B). When
sidelink is unavailable, each SL message is replaced by UL + γ·DL.
Pure float64 Python/numpy, so the joules match the JAX package's exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Sequence

MB = 1e6          # paper sizes are decimal MB
BYTE = 8.0        # bits per byte


@dataclass(frozen=True)
class EnergyParams:
    """All constants of Sect. III / Table I (SI units: J, s, bit)."""

    # computing
    P_datacenter: float = 590.0          # W (350 W GPU included)
    T_batch_datacenter: float = 0.020    # s per batch (GPU)
    P_device: float = 5.1                # W (Cortex-A72)
    T_batch_device: float = 0.400        # s per batch
    gamma: float = 1.67                  # PUE of the data center
    beta: float = 1.0                    # Jacobian factor (1 = first-order)

    # batches per round
    B_a: int = 10                        # task-adaptation batches (Eq. 3)
    B_b: int = 10                        # meta-update batches (Eq. 4)
    B_i: int = 20                        # device batches per FL round

    # data / model sizes (bits)
    data_bits: float = 24.6 * MB * BYTE  # b(E_ik), 24.6 MB
    model_bits: float = 5.6 * MB * BYTE  # b(W), 5.6 MB

    # communication efficiencies (bit/J)
    E_UL: float = 200e3
    E_DL: float = 200e3
    E_SL: float = 500e3
    sidelink_available: bool = True

    # topology
    devices_per_cluster: int = 2         # |C_i|
    meta_devices_per_task: int = 1       # robots streaming data per MAML task
    neighbors_per_device: int = 1        # |N_{k,i}| within the cluster
    K: int = 12                          # total devices (M=6 clusters × 2)

    @property
    def E0_C(self) -> float:
        """J per gradient at the data center, E0^C = P0 · T0."""
        return self.P_datacenter * self.T_batch_datacenter

    @property
    def Ek_C(self) -> float:
        """J per gradient on a device (P_k · T_k)."""
        return self.P_device * self.T_batch_device


PAPER_TABLE_I = EnergyParams()


def from_grad_per_joule(dc_grad_per_J: float = 0.03,
                        dev_grad_per_J: float = 0.16,
                        **kw) -> EnergyParams:
    """Table I's measured efficiencies ⇒ E^C = 1/efficiency J per grad."""
    p = EnergyParams(**kw)
    return replace(
        p,
        P_datacenter=(1.0 / dc_grad_per_J) / p.T_batch_datacenter,
        P_device=(1.0 / dev_grad_per_J) / p.T_batch_device,
    )


# -- Eq. (8)–(9): MAML stage --------------------------------------------------


def maml_learning_energy(p: EnergyParams, t0: int, Q: int) -> float:
    """E_ML^(L)(t0, Q) — γ · t0 · Σ_i Σ_k [B_a + β B_b] E0^C."""
    per_round = (Q * p.meta_devices_per_task
                 * (p.B_a + p.beta * p.B_b) * p.E0_C)
    return p.gamma * t0 * per_round


def maml_comm_energy(p: EnergyParams, t0: int, Q: int) -> float:
    """E_ML^(C)(Q) — UL data collection each round + one DL model push."""
    ul = t0 * Q * p.meta_devices_per_task * p.data_bits / p.E_UL
    dl = p.K * p.model_bits / p.E_DL
    return ul + dl


def maml_energy(p: EnergyParams, t0: int, Q: int) -> float:
    """Eq. (8)."""
    if t0 <= 0:
        return 0.0
    return maml_learning_energy(p, t0, Q) + maml_comm_energy(p, t0, Q)


# -- Eq. (10)–(11): FL adaptation stage ---------------------------------------


def sidelink_cost_per_bit(p: EnergyParams) -> float:
    """1/E_SL, or the UL+γ·DL replacement when SL is unavailable."""
    if p.sidelink_available:
        return 1.0 / p.E_SL
    return 1.0 / p.E_UL + p.gamma / p.E_DL


def fl_learning_energy(p: EnergyParams, t_i: float, topology=None) -> float:
    """``topology`` is ONE cluster C_i's graph (its K is |C_i|)."""
    devices = p.devices_per_cluster if topology is None else topology.K
    return t_i * devices * p.B_i * p.Ek_C


def fl_comm_energy(p: EnergyParams, t_i: float, topology=None,
                   codec=None) -> float:
    """Eq.-(11) communication term over one cluster's graph; ``codec``
    prices each exchanged model at ``codec.price_bits(b(W))``. Without a
    topology, the 2-robot constants are used (all-SL)."""
    if topology is not None:
        return t_i * topology.round_comm_joules(p, codec=codec)
    bits = p.model_bits
    if codec is not None:
        from repro_torch.comms import codecs   # deferred: import cycle
        bits = codecs.get_codec(codec).price_bits(bits)
    links = p.devices_per_cluster * p.neighbors_per_device
    return bits * t_i * links * sidelink_cost_per_bit(p)


def fl_energy(p: EnergyParams, t_i: float, topology=None,
              codec=None) -> float:
    """Eq. (10) for one task."""
    return (fl_learning_energy(p, t_i, topology)
            + fl_comm_energy(p, t_i, topology, codec))


# -- Eq. (12) -------------------------------------------------------------------


def total_energy(p: EnergyParams, t0: int, Q: int,
                 t_is: Sequence[float], topology=None,
                 codec=None) -> float:
    return maml_energy(p, t0, Q) + sum(fl_energy(p, t, topology, codec)
                                       for t in t_is)


def optimize_split(p: EnergyParams, Q: int,
                   rounds_by_t0: Dict[int, Sequence[float]]):
    """(best_t0, best_E, {t0: E}) over measured {t0: [t_1..t_M]}."""
    energies = {t0: total_energy(p, t0, Q, tis)
                for t0, tis in rounds_by_t0.items()}
    best_t0 = min(energies, key=energies.get)
    return best_t0, energies[best_t0], energies


# -- H100 pricing of the same protocol (the JAX package prices a TPU v5e) ----

#: NVIDIA H100 SXM5, typed in from NVIDIA's *H100 Tensor Core GPU* data
#: sheet (SXM5 column): bf16 dense tensor-core and f32 (non-tensor) peak
#: FLOP/s, HBM3 bytes/s and capacity, NVLink 4 bytes/s each way, one NDR
#: InfiniBand port per GPU, and the board power limit. ``host_pue`` is the
#: JAX package's data-center assumption (1.1), not a data-sheet figure.
H100_SXM = {
    "peak_flops_bf16": 989.4e12,   # FLOP/s per GPU
    "peak_flops_f32": 67e12,       # FLOP/s per GPU
    "hbm_bw": 3.35e12,             # B/s per GPU
    "hbm_bytes": 80e9,             # B per GPU
    "nvlink_bw": 450e9,            # B/s per GPU each way, within an HGX node
    "ib_bw": 50e9,                 # B/s per GPU (NDR 400 Gb/s), across nodes
    "gpus_per_node": 8,            # one HGX H100 board
    "chip_power": 700.0,           # W per GPU
    "host_pue": 1.1,
}


def link_bw(span: int, chip: dict = H100_SXM) -> float:
    """B/s per GPU of a collective whose group's ranks lie within ``span``
    consecutive ranks (its last rank − its first + 1), ranks filling the
    HGX nodes in order: NVLink when they fit in one node, InfiniBand when
    the group spans nodes."""
    return (chip["nvlink_bw"] if span <= chip["gpus_per_node"]
            else chip["ib_bw"])


@dataclass(frozen=True)
class RooflineTerms:
    """Per-step roofline terms (seconds) and their inputs, from a dry run
    (:mod:`repro_torch.launch.dryrun`): global FLOPs, bytes and collective
    bytes over ``chips`` devices, priced at an H100 SXM by default."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    peak_flops: float = H100_SXM["peak_flops_bf16"]
    hbm_bw: float = H100_SXM["hbm_bw"]
    link_bw: float = H100_SXM["ib_bw"]

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """The perfectly overlapped bound: the largest of the three."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def energy_per_step(self, power: float = H100_SXM["chip_power"],
                        pue: float = H100_SXM["host_pue"]) -> float:
        """J per step: chips × W × roofline step time × PUE."""
        return pue * self.chips * power * self.step_time


def single_chip_terms(step_terms: RooflineTerms) -> RooflineTerms:
    """The same per-step workload on ONE chip: the whole FLOP/byte budget
    lands on a single device and there are no cross-chip collectives."""
    return replace(step_terms, chips=1, collective_bytes=0.0)


def gpu_energy_params(step_terms: RooflineTerms, model_bytes: float,
                      *, chip: dict = H100_SXM,
                      chip_power: float = None,
                      dcn_bit_per_joule: float = 5e9,
                      ici_bit_per_joule: float = 50e9,
                      **overrides) -> EnergyParams:
    """Table I's shape on GPU constants, the JAX package's
    ``tpu_energy_params`` mapping: a 'gradient' is one train step; UL/DL
    are data-center network transfers, SL the links inside the slice.
    The data-center role keeps the whole ``step_terms.chips`` slice, the
    device role is ONE chip running the same workload alone
    (:func:`single_chip_terms`). ``chip_power`` (W) replaces the chip's
    board figure, e.g. with the card's ``nvidia-smi`` power limit."""
    power = chip["chip_power"] if chip_power is None else float(chip_power)
    single = single_chip_terms(step_terms)
    base = EnergyParams(
        P_datacenter=power * step_terms.chips,
        T_batch_datacenter=step_terms.step_time,
        P_device=power,
        T_batch_device=single.step_time,
        gamma=chip["host_pue"],
        model_bits=model_bytes * BYTE,
        E_UL=dcn_bit_per_joule, E_DL=dcn_bit_per_joule,
        E_SL=ici_bit_per_joule,
    )
    return replace(base, **overrides) if overrides else base


def paper_calibrated(regime: str = "fig3") -> EnergyParams:
    """Constants that reproduce the paper's reported energies: ``fig3``
    (kB/J links, 6.25 J/grad devices, near-zero data-center compute) or
    ``fig4`` (the lighter device cost of Fig. 4's curves)."""
    base = replace(
        PAPER_TABLE_I,
        E_UL=200e3 * 8, E_DL=200e3 * 8, E_SL=500e3 * 8,   # 200/500 kB/J
        P_device=(1 / 0.16) / PAPER_TABLE_I.T_batch_device,
        P_datacenter=0.05 / PAPER_TABLE_I.T_batch_datacenter,
    )
    if regime == "fig3":
        return base
    if regime == "fig4":
        return replace(base, P_device=1.25 / PAPER_TABLE_I.T_batch_device)
    raise ValueError(f"unknown calibration {regime!r}; use 'fig3' or 'fig4'")


def swap_ul_sl(p: EnergyParams) -> EnergyParams:
    """The paper's red-line regime: efficient UL, inefficient SL."""
    return replace(p, E_UL=p.E_SL, E_DL=p.E_SL, E_SL=p.E_UL)
