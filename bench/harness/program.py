"""The system under test: ``repro_torch``'s synchronous federated round, built
as its training launcher builds it (``launch/train.py``): ``model.loss`` of
the configuration, the fused server phase, the cell's uplink codec from
``get_codec(..., fused=True)`` and a ``FederatedConfig`` from the traffic mix.
The only module of the benchmark that imports the program.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

#: fields of the program's config class that name a model rather than
#: describe it; :func:`stated` says which of the others are compared
_IDENTITY = ("name", "family", "source")


def nest(flat: Dict[str, torch.Tensor]):
    """Dotted names to the program's nested dicts and lists."""
    root: dict = {}
    for name, leaf in flat.items():
        node, keys = root, name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The program's nested dicts and lists to dotted names."""
    if not isinstance(tree, (dict, list)):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {n: leaf for k, v in items for n, leaf in flatten(v, f"{prefix}{k}.").items()}


def get(tree, name: str) -> torch.Tensor:
    for k in name.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def as_json(value):
    """A config value in the form its JSON file writes it: a tuple as a list,
    a dataclass as a dict."""
    return json.loads(json.dumps(value, default=dataclasses.asdict))


def stated(config: dict, cfg) -> List[str]:
    """The fields of ``cfg``, the program's config object, that are held to
    the configuration file: every dataclass field of its own class, the
    fields that name a model left out. A field of the base ModelConfig counts
    where the file states it; one that only the program's own class adds
    always counts."""
    from repro_torch.configs.base import ModelConfig

    base = {f.name for f in dataclasses.fields(ModelConfig)}
    return [f.name for f in dataclasses.fields(cfg)
            if f.name not in _IDENTITY and (f.name in config or f.name not in base)]


def build(config: dict, seq_len: int, shapes: Dict[str, Tuple[int, ...]]):
    """The program's model of the configuration file: refused where the
    program's config object departs from a field that :func:`stated` holds to
    the file (compared in JSON form), or where its parameter tree is not
    ``shapes`` (the benchmark's layout), leaf for leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config(config["arch"])
    fields = stated(config, cfg)
    missing = [k for k in fields if k not in config]
    if missing:
        raise SystemExit(f"the configuration file does not state {missing}, fields of the "
                         f"program's {type(cfg).__name__} for {cfg.name}")
    wrong = {k: (getattr(cfg, k), config[k]) for k in fields
             if as_json(getattr(cfg, k)) != as_json(config[k])}
    if wrong:
        raise SystemExit(f"the program's {cfg.name} departs from the configuration file "
                         f"(program, file): {wrong}")
    cfg = dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len, seq_len))
    model = build_model(cfg)
    got = {n: tuple(t.shape) for n, t in flatten(model.abstract_params()).items()}
    if got != shapes:
        raise SystemExit(f"the program's parameter layout differs: {got} != {shapes}")
    return model


class Program:
    """One aggregator, built once, driven round by round."""

    def __init__(self, config: dict, traffic: dict, workload: dict, params: Dict[str, torch.Tensor],
                 seed: int, tracer=None):
        from repro_torch.core.aggregator import SyncAggregator
        from repro_torch.core.compression import get_codec
        from repro_torch.core.federated import FederatedConfig, prng_key
        from repro_torch.core.inner_opt import InnerOptConfig
        from repro_torch.core.outer_opt import OuterOptConfig
        from repro_torch.core.sampler import STRAGGLER_PROFILES, ParticipationConfig

        if traffic["aggregation"] != "sync":
            raise SystemExit(f"aggregation {traffic['aggregation']!r}: the harness drives "
                             "SyncAggregator rounds only")
        self.model = build(config, traffic["seq_len"],
                           {n: tuple(t.shape) for n, t in params.items()})
        loss_fn = self.model.loss
        if workload["remat"]:
            loss_fn = functools.partial(self.model.loss, remat=True)
        inner, outer = traffic["inner"], traffic["outer"]
        self.fed = FederatedConfig(
            clients_per_round=traffic["clients_per_round"],
            local_steps=traffic["local_steps"],
            inner=InnerOptConfig(**inner),
            outer=OuterOptConfig(**outer),
            grad_accum=workload["grad_accum"],
        )
        pcfg = ParticipationConfig(
            population=traffic["population"],
            clients_per_round=traffic["clients_per_round"],
            model=traffic["participation"],
            dropout_rate=traffic["dropout_rate"],
            straggler=STRAGGLER_PROFILES[traffic["straggler_profile"]],
        )
        codec = (get_codec(traffic["uplink"], traffic.get("topk_fraction", 0.05), fused=True)
                 if traffic["uplink"] != "float32" else None)
        self.agg = SyncAggregator(
            loss_fn, self.fed, pcfg, seed=seed, fused_server=True, params=nest(params),
            rng=prng_key(seed + 1), codec=codec, tracer=tracer,
        )

    def round(self, rnd: int, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One round on ``batch`` (leaves (τ, C, B, S)); the benchmark's data
        stands in for the cohort's streams, so every slot must take part at
        equal weight."""
        plan = self.agg.plan(rnd)
        if not plan.mask.all() or len(set(np.asarray(plan.weights).tolist())) != 1:
            raise RuntimeError(f"round {rnd}: the plan drops or weighs clients; "
                               "the traffic mix must keep every slot at equal weight")
        return self.agg.run_round(batch, plan)

    def leaf(self, name: str) -> torch.Tensor:
        return get(self.agg.state["params"], name)

    def pseudo_grad_leaf(self, name: str, theta0: torch.Tensor) -> torch.Tensor:
        """The first round's pseudo-gradient as the outer optimiser received it,
        worked out from its state after that round: FedMom's momentum lane
        holds it; FedAvg moved the weights by lr times it."""
        if self.fed.outer.name == "fedmom":
            return get(self.agg.state["outer"]["momentum"], name)
        if self.fed.outer.name == "fedavg":
            return (theta0 - self.leaf(name)) / self.fed.outer.lr
        raise ValueError(f"no pseudo-gradient readout for {self.fed.outer.name}")
