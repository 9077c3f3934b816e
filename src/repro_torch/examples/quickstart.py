"""Quickstart: federated pre-training of a tiny Photon model, the port of
``examples/quickstart.py``.

The smallest end-to-end loop: config -> model -> data sources -> synchronous
federated rounds -> held-out evaluation. This is the bottom of the stack: the
plain ``core.federated_round`` driven by hand, with the per-leaf server phase
(no kernel runs). The aggregation modes, uplink codecs, socket runtime and
closed-loop control layered above it compose in ``repro_torch.launch.train``
(``--help`` is the full flag reference); ``heterogeneous_federation`` and
``socket_federation`` show them at example scale.

  PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import (
    FederatedConfig,
    InnerOptConfig,
    OuterOptConfig,
    federated_round,
    init_federated_state,
    sample_round,
)
from repro_torch.data import build_client_streams, round_batches, validation_stream
from repro_torch.metrics import evaluate_perplexity
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves

ROUNDS, TAU, CLIENTS, POP, BATCH, SEQ = 4, 8, 4, 8, 2, 64


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    device = resolve_device(parse_args(argv).device)
    # 1. model: the paper's smallest MPT-style config, reduced
    cfg = get_config("photon-75m").reduced()
    model = build_model(cfg)
    params = model.init(0, device=device)
    print(f"model: {cfg.name} reduced -> {sum(x.numel() for x in tree_leaves(params)):,} params")

    # 2. federated configuration (Algorithm 1)
    fed = FederatedConfig(
        clients_per_round=CLIENTS,
        local_steps=TAU,
        inner=InnerOptConfig(lr_max=1e-3, warmup_steps=4, total_steps=ROUNDS * TAU),
        outer=OuterOptConfig(name="fedavg", lr=1.0),
    )
    state = init_federated_state(fed, params)

    # 3. Photon Data Sources: one private stream per population member
    streams = build_client_streams(POP, SEQ, cfg.vocab_size, heterogeneous=False)
    val = validation_stream(SEQ, cfg.vocab_size, heterogeneous=False)

    # 4. rounds: sample K clients, run tau local steps each, aggregate once
    for rnd in range(ROUNDS):
        sel = sample_round(0, rnd, POP, CLIENTS)
        batches = round_batches([streams[i] for i in sel], TAU, BATCH)
        state, metrics = federated_round(
            model.loss, fed, state, {k: torch.from_numpy(v).to(device) for k, v in batches.items()}
        )
        ppl = evaluate_perplexity(model, state["params"], val, batches=2, batch_size=BATCH)
        print(
            f"round {rnd}: clients={sel.tolist()} loss={float(metrics['train_loss']):.3f} "
            f"val_ppl={ppl:.1f} consensus={float(metrics['client_consensus']):.3f}"
        )

    print("done — the global model improved without any client sharing raw data.")


if __name__ == "__main__":
    main()
