"""Mesh descriptors, the counterpart of ``repro.launch.mesh``.

A :class:`Mesh` names its axes and their sizes and says how much memory each
device holds; ``sharding.specs`` resolves the parameters' logical axes against
it, and ``launch/steps`` builds each step's plan from it. The production
meshes are H100 fleets the port plans for but never runs: single pod
(data=16, model=16) = 256 cards, multi-pod (pod=2, data=16, model=16) = 512.
In Photon terms 'model' is the within-client model-parallel group,
('pod', 'data') indexes federated clients, and 'pod' is the hierarchical
aggregation boundary. The host mesh covers the cards this process sees, and
its steps really run.

A mesh is a plain descriptor, not a ``torch.distributed`` ``DeviceMesh``: on
one process and one card a ``DeviceMesh`` adds nothing and needs a process
group.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device

#: memory of one H100 SXM card, as the data sheet states it (80 GB); the
#: production meshes' default, whatever card the planning host has
H100_SXM_HBM_BYTES = 80 * 10**9


class Mesh:
    """Axis names and sizes, memory per device and, for a host mesh, the
    devices it covers (a production mesh has none: it is never run)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], hbm_bytes: float,
                 devices: Tuple[torch.device, ...] = ()):
        assert len(shape) == len(axis_names), (shape, axis_names)
        self.shape: Dict[str, int] = OrderedDict(zip(axis_names, (int(n) for n in shape)))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.hbm_bytes = float(hbm_bytes)
        self.devices = tuple(devices)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def device(self) -> Optional[torch.device]:
        """The device a host mesh's steps run on (its first)."""
        return self.devices[0] if self.devices else None

    def require_one_device(self) -> None:
        """The port runs no program across cards: a step that lays out a
        client-stacked tree over a mesh of more than one device is refused."""
        if self.size > 1:
            raise NotImplementedError(
                f"the port runs one card per program; this mesh spans {self.size} devices")

    def __repr__(self) -> str:
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        return f"Mesh({axes}, hbm_bytes={self.hbm_bytes:.4g})"


def card_memory_bytes(device="cuda") -> int:
    """Total memory of one card (``device``'s), or of the host for ``cpu``."""
    device = resolve_device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def make_production_mesh(*, multi_pod: bool = False,
                         hbm_bytes: float = H100_SXM_HBM_BYTES) -> Mesh:
    """(16, 16) or (2, 16, 16) H100s with the data sheet's 80 GB each, so a
    fleet's plan does not depend on the host that prints it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, hbm_bytes)


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """(data, model) over the cards this process sees (``device="cpu"``: the
    host, one device); cuda without a card raises."""
    device = resolve_device(device)
    if device.type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        devices = (device,)
    n = len(devices)
    assert n % model == 0, (n, model)
    return Mesh((n // model, model), ("data", "model"), card_memory_bytes(devices[0]), devices)
