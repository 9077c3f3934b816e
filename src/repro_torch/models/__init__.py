"""The dense attention decoder (the photon family) in PyTorch."""
from repro_torch.models.model import Model, build_model  # noqa: F401
