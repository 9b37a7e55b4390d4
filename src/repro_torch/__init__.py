"""PyTorch/CUDA port of the federated multi-task learning system.

Mirrors the JAX package's module tree (``core``, ``comms``, ``kernels``,
``models``, ``rl``). The two Eq.-(6) consensus kernels are hand-written
CUDA for Hopper (``kernels/csrc``); everything else is plain PyTorch.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
import torch


def set_f32_matmul() -> None:
    """Keep float32 products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
