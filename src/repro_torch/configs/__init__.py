"""Configs the port runs (its own copy; see :mod:`repro_torch.configs.base`)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, RGLRUConfig, get_arch, reduced, register)
from repro_torch.configs.paper_dqn import PAPER_DQN  # noqa: F401
from repro_torch.configs.recurrentgemma_9b import RECURRENTGEMMA_9B  # noqa: F401
