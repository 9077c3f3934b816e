"""Roofline analysis of a step measured on the card, the counterpart of
``repro.roofline.analysis``.

The reference reads its terms from XLA's compiled artifacts. The port has no
compiled program, so it measures one run of the step instead
(:func:`measure`):

  - FLOPs and bytes from a ``TorchDispatchMode`` counter over every aten op
    of one run (forward, recomputation and backward alike), by the rules of
    ``repro/roofline/hlo_analyzer.py``:
      dot / convolution  ``torch.utils.flop_counter``'s formula (2·M·N·K)
      reduction          1 × operand elements
      other arithmetic   1 × result elements
      data movement      0 (copies, casts, creation, gathers, concatenation)
      bytes              operand + result bytes of every op that is not a
                         view (or an undeclared alias, ``_unsafe_view``): in
                         eager mode every op's boundary reaches HBM, as
                         every fusion boundary does in XLA
      collectives        0 bytes: the port's steps run on one card
  - peak memory from ``torch.cuda.max_memory_allocated`` around a second,
    uncounted run, whose wall time is the step's time.

The hand-written kernels are launched through ``ctypes`` and are invisible to
the counter: a report lists them by name with their launch counts, as not
counted.

The three roofline terms for one H100 SXM:
    compute    = FLOPs / 989e12
    memory     = bytes / 3.35e12
    collective = collective bytes / 450e9
Every term is None where the plan cannot know it (a production mesh's plan is
never run).
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pytree_leaves

# H100 SXM per-card peaks, as the data sheet states them
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
ICI_BW = 450e9  # B/s per direction, NVLink 4

#: aten ops that return a view of their input without declaring it a view
ALIASES = frozenset({"_unsafe_view", "alias", "lift_fresh"})

#: aten ops that move or create data and do no arithmetic
DATA_MOVEMENT = frozenset({
    "copy_", "_to_copy", "clone", "contiguous", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "fill_", "zero_", "cat", "stack",
    "index", "index_select", "gather", "scatter", "scatter_", "index_put", "index_put_",
    "index_copy", "index_copy_", "slice_scatter", "select_scatter", "constant_pad_nd",
    "repeat", "embedding", "arange", "lift_fresh_copy",
    "expand_copy", "randn", "rand", "randint", "normal_", "uniform_", "random_",
    "_local_scalar_dense", "resize_", "set_", "masked_scatter", "flip", "roll", "tril",
    "triu",
})

#: aten ops that reduce: 1 FLOP per operand element
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "norm", "linalg_vector_norm",
    "prod", "var", "std", "var_mean", "argmax", "argmin", "any", "all", "cumsum",
    "_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "topk", "sort", "embedding_dense_backward", "index_add", "index_add_", "scatter_add",
    "scatter_add_",
})


def _tensors(tree):
    return [x for x in _pytree_leaves(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op run under it (see the
    module docstring), in total and per op name."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.by_op: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])  # calls, flops, bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket.__name__ in ALIASES:
            return out
        name = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if func.overloadpacket in self._registry:
            flops = float(self._registry[func.overloadpacket](*args, **kwargs, out_val=out))
        elif name in DATA_MOVEMENT:
            flops = 0.0
        elif name in REDUCTIONS:
            flops = float(max((t.numel() for t in ins), default=0))
        else:
            flops = float(sum(t.numel() for t in outs))
        self.flops += flops
        self.bytes += nbytes
        self.ops += 1
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out


@dataclass
class Measured:
    """One counted run and one timed run of a step on one device."""

    flops: float  # counted FLOPs of the run
    bytes: float  # counted bytes of the run
    ops: int  # aten ops counted
    seconds: float  # wall time of the uncounted run
    peak_memory: Optional[float]  # bytes; None off the card
    kernels_not_counted: Dict[str, int]  # launches of the hand-written kernels per run
    by_op: Dict[str, list] = field(default_factory=dict)  # name -> [calls, flops, bytes]
    output: Any = None  # the timed run's output, when measure(keep_output=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn: Callable, args: Sequence, device, *, top_ops: int = 12,
            keep_output: bool = False) -> Measured:
    """Runs ``fn(*args)`` twice on ``device``: once under :class:`OpCounter`
    (with the kernels' launches counted), then once timed, with the card's
    peak memory read around the timed run. The counted run's outputs are
    dropped before the timed run starts, and the timed run's unless
    ``keep_output``. Returns a :class:`Measured` whose ``by_op`` keeps the
    ``top_ops`` ops of most bytes."""
    from repro_torch.kernels import all_kernels

    cuda = torch.device(device).type == "cuda"
    kernels = all_kernels()
    before = {n: k.launches for n, k in kernels.items()}
    counter = OpCounter()
    with counter:
        out = fn(*args)
    _sync(device)
    launched = {n: k.launches - before[n] for n, k in kernels.items()}
    del out
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    seconds = time.perf_counter() - t0
    peak = float(torch.cuda.max_memory_allocated(device)) if cuda else None
    top = sorted(counter.by_op.items(), key=lambda kv: -kv[1][2])[:top_ops]
    return Measured(flops=counter.flops, bytes=counter.bytes, ops=counter.ops,
                    seconds=seconds, peak_memory=peak,
                    kernels_not_counted={n: c for n, c in launched.items() if c},
                    by_op={k: list(v) for k, v in top}, output=out if keep_output else None)


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclass
class RooflineReport:
    name: str
    chips: int
    flops_per_device: Optional[float]
    bytes_per_device: Optional[float]
    collective_bytes_per_device: Optional[float]
    collective_detail: Optional[Dict[str, float]]
    collective_counts: Optional[Dict[str, int]]
    model_flops: Optional[float] = None  # 6*N*D fleet-wide
    peak_memory_per_device: Optional[float] = None
    extra: Dict = field(default_factory=dict)

    @property
    def t_compute(self) -> Optional[float]:
        return None if self.flops_per_device is None else self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> Optional[float]:
        return None if self.bytes_per_device is None else self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.collective_bytes_per_device is None:
            return None
        return self.collective_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> Optional[str]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        if any(v is None for v in terms.values()):
            return None
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops_per_device is None:
            return None
        fleet = self.flops_per_device * self.chips
        return self.model_flops / fleet if fleet else None

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_detail": self.collective_detail,
            "collective_counts": self.collective_counts,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_memory_per_device": self.peak_memory_per_device,
            **self.extra,
        }


def analyze_compiled(name: str, measured: Optional[Measured], chips: int,
                     model_flops: Optional[float] = None,
                     extra: Optional[Dict] = None) -> RooflineReport:
    """The report of a step: from a :class:`Measured` run on one card, or
    from a plan alone (``measured=None``: every measured term None)."""
    extra = dict(extra or {})
    if measured is None:
        return RooflineReport(name=name, chips=chips, flops_per_device=None,
                              bytes_per_device=None, collective_bytes_per_device=None,
                              collective_detail=None, collective_counts=None,
                              model_flops=model_flops, extra=extra)
    extra["measured"] = {"seconds": measured.seconds, "aten_ops": measured.ops,
                         "kernels_not_counted": measured.kernels_not_counted,
                         "top_ops_by_bytes": measured.by_op}
    stats = CollectiveStats()  # one card: no collective
    return RooflineReport(
        name=name,
        chips=chips,
        flops_per_device=measured.flops,
        bytes_per_device=measured.bytes,
        collective_bytes_per_device=stats.total_bytes,
        collective_detail=stats.bytes_by_kind,
        collective_counts=stats.count_by_kind,
        model_flops=model_flops,
        peak_memory_per_device=measured.peak_memory,
        extra=extra,
    )


def model_flops_6nd(n_params_active: int, n_tokens: int, train: bool = True) -> float:
    """6·N·D for a train step (fwd+bwd); 2·N·D for inference."""
    return (6.0 if train else 2.0) * n_params_active * n_tokens
