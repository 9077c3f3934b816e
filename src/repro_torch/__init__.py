"""PyTorch/CUDA port of the Photon federated pre-training system.

Imports torch and numpy, never JAX and nothing of ``repro`` (the JAX package
it is held against). Module names mirror ``repro``'s; the parameter and state
trees keep the reference's key paths, so checkpoints and flat buffers match
element for element. See ``README.md`` in this directory.
"""
