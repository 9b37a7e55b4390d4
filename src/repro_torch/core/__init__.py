"""The paper's contribution, ported: MAML (Eqs. 2-5), decentralized
consensus FL (Eq. 6), the energy model (Eqs. 8-12) and the two-stage
protocol. Import the submodules directly."""
