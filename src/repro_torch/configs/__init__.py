"""Configs the port runs (its own copy; see :mod:`repro_torch.configs.base`)."""
from repro_torch.configs.base import ArchConfig, get_arch, register  # noqa: F401
from repro_torch.configs.paper_dqn import PAPER_DQN  # noqa: F401
