from repro_torch.checkpoint.store import (save_pytree, restore_pytree,
                                          CheckpointManager)
