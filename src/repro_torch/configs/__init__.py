"""Configs the port runs (its own copy; see :mod:`repro_torch.configs.base`).
Importing this package registers every one of them."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, ArchConfig, EncDecConfig, InputShape, MoEConfig,
    RGLRUConfig, XLSTMConfig, get_arch, list_archs, reduced, register)
from repro_torch.configs.chameleon_34b import CHAMELEON_34B  # noqa: F401
from repro_torch.configs.deepseek_7b import DEEPSEEK_7B  # noqa: F401
from repro_torch.configs.granite_8b import GRANITE_8B  # noqa: F401
from repro_torch.configs.h2o_danube_3_4b import H2O_DANUBE_3_4B  # noqa: F401
from repro_torch.configs.mixtral_8x7b import MIXTRAL_8X7B  # noqa: F401
from repro_torch.configs.paper_dqn import PAPER_DQN  # noqa: F401
from repro_torch.configs.qwen2_moe_a2_7b import QWEN2_MOE_A2_7B  # noqa: F401
from repro_torch.configs.recurrentgemma_9b import RECURRENTGEMMA_9B  # noqa: F401
from repro_torch.configs.stablelm_3b import STABLELM_3B  # noqa: F401
from repro_torch.configs.whisper_large_v3 import WHISPER_LARGE_V3  # noqa: F401
from repro_torch.configs.xlstm_125m import XLSTM_125M  # noqa: F401
