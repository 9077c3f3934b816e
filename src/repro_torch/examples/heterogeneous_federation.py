"""Heterogeneous federation (paper §6.3 + Fig 4 + §7), the port of
``examples/heterogeneous_federation.py``: eight institutions with different
text domains (the Pile categories) collaborate; no bucket is ever shared
between two clients (§6.2.1). On top of the statistical heterogeneity the run
layers the paper's §7 systems heterogeneity: clients churn on and off (Markov
availability), fail mid-round (seeded dropout), run on unequal hardware (the
heavy straggler profile) and hold unequal corpora (FedAvg data-size
weighting). It tracks the consensus metric and the effective cohort per round.

``--aggregation async`` swaps the deadline-cut synchronous round for the
FedBuff-style buffered aggregator: slow institutions finish late and land in
later buffers with staleness-discounted weights, and the server applies one
outer update per ``--buffer-size`` admitted deltas.

``--uplink`` compresses each institution's pseudo-gradient before it crosses
the wire; with ``topk`` every client carries its own error-feedback residual,
keyed by client id across interleaved completions and flushes.

``--partial-progress`` credits a slow institution the τ_i steps it finished,
down-weighted by τ_i/τ, instead of cutting it at the deadline.

``--control`` closes the loop between the telemetry and the knobs:
``staleness`` (async) governs the buffer size and the staleness discount
toward a ``--control-target`` staleness quantile; ``cohort`` (sync) tunes the
straggler deadline from the effective-K fraction. Applied knob updates print
per round and, with ``--trace``, land as ``knob_update`` events in the JSONL.

``--fused-server`` is the switch the train CLI has under the same name: the
server phase becomes one ``server_apply`` pass over the flat (C, N) delta
buffer and a compressed uplink takes the fused codecs, so on the card the
CUDA fedcore kernels run (``server_apply`` once per round or flush; with
``--uplink topk`` ``topk_mask_ef`` once per client phase; with ``int8``
``int8_quant`` per client phase and ``int8_dequant`` per admission). Off, as
by default, the run is the reference example's.

  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_federation --device cpu
  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_federation \\
      --aggregation async --uplink int8 --fused-server --rounds 2          # on the card
  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_federation --device cpu \\
      --partial-progress --straggler-profile heavy --rounds 2
  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_federation --device cpu \\
      --aggregation async --control staleness --control-target 3 --rounds 2 \\
      --trace /tmp/hetero.jsonl
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.control import CohortTuner, FederationController, StalenessGovernor
from repro_torch.core import (
    STRAGGLER_PROFILES,
    UPLINK_SCHEMES,
    AsyncAggConfig,
    AsyncFederationDriver,
    FederatedConfig,
    InnerOptConfig,
    OuterOptConfig,
    ParticipationConfig,
    SyncAggregator,
    get_codec,
    uplink_bytes,
)
from repro_torch.data import PILE_CATEGORIES, build_client_streams, round_batches, validation_stream
from repro_torch.metrics import evaluate_perplexity, participation_metrics, partial_progress_metrics
from repro_torch.models import build_model
from repro_torch.obs import JsonlSink, Tracer

TAU, CLIENTS, BATCH, SEQ, SEED = 8, 8, 2, 64, 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--aggregation", default="sync", choices=["sync", "async"])
    ap.add_argument("--rounds", type=int, default=5,
                    help="sync rounds, or async outer updates")
    ap.add_argument("--buffer-size", type=int, default=4,
                    help="async: deltas per outer update")
    ap.add_argument("--staleness-alpha", type=float, default=0.5)
    ap.add_argument("--uplink", default="float32", choices=list(UPLINK_SCHEMES),
                    help="pseudo-gradient uplink codec")
    ap.add_argument("--topk-fraction", type=float, default=0.05)
    ap.add_argument("--straggler-profile", default="heavy",
                    choices=sorted(STRAGGLER_PROFILES),
                    help="hardware-heterogeneity preset")
    ap.add_argument("--partial-progress", action="store_true",
                    help="credit stragglers their realized τ_i steps at weight "
                         "τ_i/τ instead of cutting them at the deadline")
    ap.add_argument("--control", default="static",
                    choices=["static", "staleness", "cohort"],
                    help="closed-loop knob control: staleness needs "
                         "--aggregation async, cohort sync")
    ap.add_argument("--control-target", type=float, default=None,
                    help="policy setpoint: staleness-quantile value (async) "
                         "or effective-K fraction (sync)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append structured events (incl. knob_update) to "
                         "this JSONL file")
    ap.add_argument("--fused-server", action="store_true",
                    help="server phase as one fused pass over the flat (C, N) delta "
                         "buffer, and the fused uplink codecs (the CUDA fedcore "
                         "kernels on the card)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def build_controller(args):
    """``--control`` → controller (or None), paired as the train CLI pairs
    them: the governor owns async knobs, the tuner sync ones."""
    if args.control == "static":
        return None
    if args.control == "staleness":
        if args.aggregation != "async":
            raise SystemExit("--control staleness requires --aggregation async")
        policy = StalenessGovernor(
            staleness_alpha=args.staleness_alpha,
            buffer_size=args.buffer_size,
            target=args.control_target if args.control_target is not None else 1.0,
            buffer_max=max(args.buffer_size, CLIENTS),
        )
    else:
        if args.aggregation != "sync":
            raise SystemExit("--control cohort requires --aggregation sync")
        policy = CohortTuner(
            clients_per_round=CLIENTS,
            deadline=STRAGGLER_PROFILES[args.straggler_profile].deadline,
            population=CLIENTS,
            target=args.control_target if args.control_target is not None else 0.9,
        )
    # window=2: the example runs only a handful of updates, so decisions must
    # fire off early evidence
    return FederationController(policy, window=2)


def main(argv=None):
    """Runs the example; returns its ``SyncAggregator`` or
    ``AsyncFederationDriver`` (their launch-relevant counters and state)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("photon-75m").reduced()
    model = build_model(cfg)
    fed = FederatedConfig(
        clients_per_round=CLIENTS,
        local_steps=TAU,
        inner=InnerOptConfig(lr_max=1e-3, warmup_steps=4, total_steps=args.rounds * TAU),
        outer=OuterOptConfig(name="fedavg", lr=1.0),
    )

    # one client per Pile category — publishers from different domains (Fig 1)
    streams = build_client_streams(
        CLIENTS, SEQ, cfg.vocab_size, heterogeneous=True,
        n_categories=len(PILE_CATEGORIES), j_max=1,
    )
    print("clients:", ", ".join(PILE_CATEGORIES[:CLIENTS]))
    val = validation_stream(SEQ, cfg.vocab_size, heterogeneous=True)

    # systems heterogeneity on top of the statistical kind
    pcfg = ParticipationConfig(
        population=CLIENTS,
        clients_per_round=CLIENTS,
        model="markov",
        dropout_rate=0.15,
        straggler=STRAGGLER_PROFILES[args.straggler_profile],
        weighting="examples",
        partial_progress=args.partial_progress,
        local_steps=TAU if args.partial_progress else 0,
    )

    codec = (
        get_codec(args.uplink, args.topk_fraction, fused=args.fused_server)
        if args.uplink != "float32" else None
    )
    tracer = (
        Tracer(sink=JsonlSink(args.trace), proc="example", trace_id="hetero")
        if args.trace else None
    )
    controller = build_controller(args)
    if args.aggregation == "async":
        try:
            return run_async(args, device, cfg, model, fed, pcfg, streams, val, codec,
                             tracer=tracer, controller=controller)
        finally:
            if tracer is not None:
                tracer.close()

    params = model.init(0, device=device)
    if codec is not None:
        print(f"uplink codec: {codec!r} "
              f"({uplink_bytes(params, 'float32') / codec.nbytes(params):.1f}x "
              f"fewer bytes per upload)")
    # the aggregator owns admission (the plan's mask / partial τ_i), the
    # weight policy (n_k·τ_i/τ) and the checkpoint schema; the example only
    # moves batches
    agg = SyncAggregator(model.loss, fed, pcfg, codec=codec, seed=SEED, params=params,
                         fused_server=args.fused_server, tracer=tracer, controller=controller)
    try:
        for rnd in range(args.rounds):
            plan = agg.plan(rnd)
            # bind streams by the plan's slot ids so weights stay aligned with data
            batches = round_batches([streams[i] for i in plan.selected], TAU, BATCH)
            m = agg.run_round({k: torch.from_numpy(v).to(device) for k, v in batches.items()},
                              plan)
            ppl = evaluate_perplexity(model, agg.state["params"], val, batches=2,
                                      batch_size=BATCH)
            partial = ""
            if args.partial_progress:
                pm = partial_progress_metrics(plan, TAU)
                partial = (f" tau={pm['partial_tau_mean']:.2f} "
                           f"rescued={pm['partial_rescued_clients']:.0f}")
            print(
                f"round {rnd}: loss={float(m['train_loss']):.3f} val_ppl={ppl:.1f} "
                f"consensus={float(m['client_consensus']):.3f} "
                f"pg_norm={float(m['pseudo_grad_norm']):.4f} "
                f"eff_K={plan.effective_k}/{CLIENTS} "
                f"stragglers={plan.n_stragglers} dropped={plan.n_dropped} "
                f"w_entropy={float(m['weight_entropy']):.2f}{partial}"
            )
            # round-boundary control point: the cohort tuner may retune the
            # deadline/cohort for the next round from this round's participation
            update = agg.control_step({
                **participation_metrics(plan),
                **partial_progress_metrics(plan, TAU),
            })
            if update is not None:
                print("  control: " + ", ".join(
                    f"{k}={v:g}" for k, v in update.knob_dict().items()
                ))
    finally:
        if tracer is not None:
            tracer.close()
    print("heterogeneous federation converged under churn (paper claims C3 + §7).")
    return agg


def run_async(args, device, cfg, model, fed, pcfg, streams, val, codec=None,
              tracer=None, controller=None):
    """The same federation, asynchronously: slow institutions finish late and
    are buffered with staleness discounts instead of being cut at the deadline."""
    acfg = AsyncAggConfig(
        buffer_size=args.buffer_size, staleness_alpha=args.staleness_alpha
    )

    def make_batches(cid):
        b = round_batches([streams[cid]], TAU, BATCH)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    params = model.init(0, device=device)
    if codec is not None:
        print(f"uplink codec: {codec!r} "
              f"({uplink_bytes(params, 'float32') / codec.nbytes(params):.1f}x "
              f"fewer bytes per upload)")
    driver = AsyncFederationDriver(
        model.loss, fed, acfg, pcfg, make_batches,
        seed=SEED, params=params, codec=codec, fused_server=args.fused_server,
        tracer=tracer, controller=controller,
    )

    def on_update(i, row):
        ppl = evaluate_perplexity(
            model, driver.state["params"], val, batches=2, batch_size=BATCH
        )
        print(
            f"update {i}: loss={row['train_loss_mean']:.3f} val_ppl={ppl:.1f} "
            f"consensus={row['client_consensus']:.3f} "
            f"pg_norm={row['pseudo_grad_norm']:.4f} "
            f"staleness={row['staleness_mean']:.2f}/{row['staleness_max']:.0f} "
            f"buf={row['buffer_fill']:.0f}/{driver.acfg.buffer_size} "
            f"t_sim={row['sim_time']:.2f}"
        )
        knobs = {k[len("knob_"):]: v for k, v in row.items()
                 if k.startswith("knob_")}
        if knobs:
            print("  control: " + ", ".join(
                f"{k}={v:g}" for k, v in knobs.items()
            ))

    driver.run_updates(args.rounds, on_update=on_update)
    driver.finalize_trace()
    uplink = (
        f", uplink: {driver.uplink_bytes_total / 1e6:.1f} MB" if codec else ""
    )
    print(
        f"async federation applied {args.rounds} buffered updates in "
        f"{driver.sim_time:.2f} simulated median-rounds "
        f"(client work aggregated: {driver.work_completed:.1f}, "
        f"wasted: {driver.work_wasted:.1f}{uplink}) — no straggler discarded."
    )
    return driver


if __name__ == "__main__":
    main()
