"""The port's models in PyTorch: the dense attention decoder (the photon
family) and the Mamba2 SSM stack, with the prefill/decode caches."""
from repro_torch.models.model import Model, build_model, cross_entropy  # noqa: F401
