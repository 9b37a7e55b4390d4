"""Models of the port: the paper's DQN Q-network."""
