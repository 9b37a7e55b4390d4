"""Models of the port: the paper's DQN Q-network and the RecurrentGemma
hybrid (``rglru``), dispatched by family in ``api``."""
