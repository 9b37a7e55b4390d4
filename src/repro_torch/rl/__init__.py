"""The paper's Sect.-IV robot case study, ported."""
