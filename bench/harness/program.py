"""The system under test: ``repro_torch``'s synchronous federated round, built
as its training launcher builds it (``launch/train.py``): ``model.loss`` of
the configuration, the fused server phase, the cell's uplink codec from
``get_codec(..., fused=True)`` and a ``FederatedConfig`` from the traffic mix.
The only module of the benchmark that imports the program.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

#: fields of the program's ModelConfig a configuration file may state
_CONFIG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                  "pos_embedding", "norm", "activation", "tie_embeddings", "z_loss",
                  "param_dtype", "compute_dtype", "ssm_state", "ssm_head_dim", "ssm_expand",
                  "ssm_conv_width", "ssm_n_groups")


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


def get(tree, name: str) -> torch.Tensor:
    for k in name.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


class Program:
    """One aggregator, built once, driven round by round."""

    def __init__(self, config: dict, traffic: dict, workload: dict, params: Dict[str, torch.Tensor],
                 seed: int, tracer=None):
        from repro_torch.configs import get_config
        from repro_torch.core.aggregator import SyncAggregator
        from repro_torch.core.compression import get_codec
        from repro_torch.core.federated import FederatedConfig, prng_key
        from repro_torch.core.inner_opt import InnerOptConfig
        from repro_torch.core.outer_opt import OuterOptConfig
        from repro_torch.core.sampler import STRAGGLER_PROFILES, ParticipationConfig
        from repro_torch.models.model import build_model

        if traffic["aggregation"] != "sync":
            raise SystemExit(f"aggregation {traffic['aggregation']!r}: the harness drives "
                             "SyncAggregator rounds only")
        cfg = get_config(config["arch"])
        wrong = {k: (getattr(cfg, k), config[k]) for k in _CONFIG_FIELDS
                 if k in config and getattr(cfg, k) != config[k]}
        if wrong:
            raise SystemExit(f"the program's {cfg.name} departs from the configuration file "
                             f"(program, file): {wrong}")
        cfg = dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len, traffic["seq_len"]))
        self.model = build_model(cfg)
        want = {n: tuple(t.shape) for n, t in params.items()}
        abstract = self.model.abstract_params()
        shapes = {n: tuple(get(abstract, n).shape) for n in want}
        if shapes != want:
            raise SystemExit(f"the program's parameter layout differs: {shapes} != {want}")
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
