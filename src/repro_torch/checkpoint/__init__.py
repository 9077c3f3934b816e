from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    TensorSpec,
    load_pytree,
    save_pytree,
)
