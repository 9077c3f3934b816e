"""PyTorch/CUDA port of the Photon federated pre-training system.

Imports torch and numpy, never JAX and nothing of ``repro`` (the JAX package
it is held against). Module names mirror ``repro``'s; the parameter and state
trees keep the reference's key paths, so checkpoints and flat buffers match
element for element. See ``README.md`` in this directory.

Entry points that take a ``device`` run on ``"cuda"`` unless the caller asks
for the CPU; :func:`resolve_device` makes cuda without a card an error, never
a silent fall back.
"""
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; cuda without a visible card is an
    error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was asked for, but torch sees no CUDA device")
    return device
