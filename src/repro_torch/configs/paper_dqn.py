"""The paper's own model: DeepMind DQN Q-network (Mnih et al. 2015), 5
trainable layers, adapted to the 40-landmark gridworld state (Sect. IV).
Source: DOI:10.1109/PIMRC54779.2022.9977688 + Mnih et al. 2015.
"""
from repro_torch.configs.base import ArchConfig, register

PAPER_DQN = register(ArchConfig(
    name="paper-dqn",
    family="dqn",
    num_layers=5,
    d_model=512,            # fc width
    num_heads=1,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=4,           # |actions| = {F, B, L, R}
    citation="DOI:10.1109/PIMRC54779.2022.9977688 + Mnih et al. 2015",
    dtype="float32",
    param_dtype="float32",
    remat=False,
))
