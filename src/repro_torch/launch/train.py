"""Federated pre-training driver, ``repro.launch.train`` in PyTorch:
reproducible client sampling, per-round stream binding, local training, the
server step, held-out validation, the CSV log and checkpoint/auto-resume.
Checkpoints are the reference's format: a run of either package resumes the
other's.

``--aggregation sync`` (the default) runs deadline-masked rounds.
``--aggregation async`` runs FedBuff-style buffered aggregation
(``core/aggregator.AsyncFederationDriver``): K client slots stay busy on a
simulated timeline, each completion's delta is admitted into a server buffer
with a staleness-discounted weight, and one outer update applies per
``--buffer-size`` admitted deltas; every update checkpoints the buffer, the
in-flight slots and the dispatch cursor, so ``--resume`` continues bitwise.

``--cohort-tile`` (sync) streams the cohort through the round a tile of
clients at a time, so the ``(C, N)`` delta buffer is bounded by the tile; one
tile is bitwise the flat round. ``--robust-agg {trimmed,median,normclip}``
swaps the server's weighted mean for a robust rule (a per-tile fold under
``--cohort-tile``), ``--screen`` zero-weights (sync) or refuses at the buffer
door (async) non-finite and norm-outlier deltas and quarantines their
senders, and ``--rollback`` (with ``--ckpt-dir``) restores the server from the
last good checkpoint when an update norm spikes or goes non-finite; their
state rides the checkpoint manifest. ``--byzantine-fraction`` (async) makes
the lowest population ids attackers that corrupt every upload
(``--byzantine-kind``).

``--control`` closes the loop between telemetry and the aggregation knobs
(``control/``): ``staleness`` (async) moves ``--staleness-alpha`` and the
buffer size M (powers of two up to ``max(M, K)``) toward a target
admitted-staleness quantile; ``cohort`` (sync) moves the straggler deadline
and K (steps of 2) toward a target effective-K fraction; ``static`` (the
default) is bitwise the uncontrolled run. Updates land at flush or round
boundaries and the controller's state rides the checkpoint manifest.

``--runtime sockets`` (async) turns the simulated timeline into processes:
``--role server`` owns the aggregator, the dispatch manifest and every
client's data cursor behind the length-prefixed socket protocol
(``runtime/``); ``--role client`` workers pull assignments, run the client
phase on their ``--device`` and push the encoded payloads back. Leases
redispatch a dead worker's slot, ``--flush-deadline`` flushes past a stalled
one, ``--chaos-*`` injects faults, and with the same seeds the final params
are bitwise the in-process run's. ``--trace PATH`` appends the run's events
as JSONL (``obs/``; merge and check them with ``python -m
repro_torch.obs.report``) and ``--metrics-port`` serves Prometheus text;
neither changes a result.

``--fused-server`` runs the server step (weighted mean + DP noise + outer
update + its norms) as one pass over the flat ``(C, N)`` delta buffer — on the
card, the hand-written CUDA ``server_apply`` kernel (async: once per flush,
over the ``(M, N)`` buffer). ``--uplink {bf16,int8,topk}`` compresses each
client's pseudo-gradient before it crosses the wire; with ``--fused-server``
the codecs are the flat-buffer ones, whose encode (and int8 decode) run as
CUDA kernels on the card. The run is on ``cuda`` unless ``--device cpu`` is
given; asking for cuda where there is none is an error, never a silent fall
back.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server \\
      --uplink topk
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server \\
      --aggregation async --straggler-profile heavy --dropout-rate 0.1
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --clients 16 \\
      --cohort-tile 4 --robust-agg trimmed
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server \\
      --aggregation async --byzantine-fraction 0.25 --byzantine-kind nan --rollback \\
      --ckpt-dir "$(mktemp -d)"
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server \\
      --aggregation async --straggler-profile heavy --control staleness --trace run.jsonl
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server \\
      --aggregation async --runtime sockets --role server --port 5555 --uplink int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server \\
      --aggregation async --runtime sockets --role client --port 5555 --uplink int8 \\
      --worker-id w0
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --local-steps 2 --clients 2 --population 4 --seq-len 64 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.control import CohortTuner, FederationController, KnobUpdate, StalenessGovernor
from repro_torch.core import (
    CORRUPT_KINDS,
    ROBUST_RULES,
    STRAGGLER_PROFILES,
    UPLINK_SCHEMES,
    AsyncAggConfig,
    AsyncBufferAggregator,
    AsyncFederationDriver,
    FederatedConfig,
    InnerOptConfig,
    OuterOptConfig,
    ParticipationConfig,
    RobustAggConfig,
    SyncAggregator,
    get_codec,
    make_byzantine_fn,
    plan_round,
    prng_key,
)
from repro_torch.data import build_client_streams, round_batches, validation_stream
from repro_torch.metrics import (
    MetricLogger,
    evaluate_perplexity,
    partial_progress_metrics,
    participation_metrics,
    perplexity,
    staleness_stats,
    uplink_round_metrics,
    wallclock_speedup,
)
from repro_torch.models import build_model
from repro_torch.obs import JsonlSink, MetricsServer, Tracer
from repro_torch.runtime import ChaosConfig, ClientWorker, FederationDriver, SocketBackend


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; cuda without a visible card is an error."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch sees no CUDA device")
    return torch.device(name)


def _chaos_from_args(args):
    chaos = ChaosConfig(
        drop=args.chaos_drop, delay=args.chaos_delay, kill=args.chaos_kill,
        corrupt=args.chaos_corrupt,
        corrupt_kinds=tuple(k.strip() for k in args.chaos_corrupt_kinds.split(",") if k.strip()),
        seed=args.chaos_seed,
    )
    return chaos if chaos.active else None


def _robust_from_args(args):
    """The robust flags as a :class:`RobustAggConfig`, or None when every
    defense is off (no robust code runs then)."""
    if args.robust_agg == "none" and not args.screen and not args.rollback:
        return None
    return RobustAggConfig(
        rule=args.robust_agg,
        trim_fraction=args.trim_fraction,
        clip_mult=args.clip_mult,
        clip_norm=args.clip_norm,
        screen=args.screen,
        screen_z=args.screen_z,
        screen_warmup=args.screen_warmup,
        rollback=args.rollback,
        rollback_window=args.rollback_window,
        rollback_factor=args.rollback_factor,
        quarantine_rounds=args.quarantine_rounds,
    )


def _build_tracer(args, proc):
    """One tracer per process: events go to ``--trace`` (JSONL), counters feed
    ``--metrics-port``; None when neither is set."""
    if args.trace is None and args.metrics_port is None:
        return None
    sink = JsonlSink(args.trace) if args.trace else None
    return Tracer(sink=sink, proc=proc, trace_id=f"seed{args.seed}")


def _start_metrics(args, tracer, extra=None):
    if tracer is None or args.metrics_port is None:
        return None
    srv = MetricsServer(tracer, port=args.metrics_port, extra=extra)
    print(f"metrics serving on {srv.host}:{srv.port}", flush=True)
    return srv


def _build_controller(args, acfg=None, straggler=None):
    """``--control`` → a :class:`FederationController`, or None for static;
    refuses a policy the aggregation cannot host, in the reference's words."""
    if args.control == "static":
        return None
    if args.control == "staleness":
        if args.aggregation != "async":
            raise SystemExit(
                "--control staleness drives the async buffer knobs "
                "(--staleness-alpha/--buffer-size) — it requires "
                "--aggregation async; for sync runs use --control cohort"
            )
        policy = StalenessGovernor(
            staleness_alpha=args.staleness_alpha,
            buffer_size=acfg.buffer_size,
            target=args.control_target if args.control_target is not None else 1.0,
            quantile=args.control_quantile,
            gain=args.control_gain if args.control_gain is not None else 0.5,
            buffer_max=max(acfg.buffer_size, args.clients),
        )
    else:  # cohort
        if args.aggregation != "sync":
            raise SystemExit(
                "--control cohort drives the sync deadline/cohort knobs — it "
                "requires --aggregation sync; for async runs use "
                "--control staleness"
            )
        if args.keep_opt:
            raise SystemExit(
                "--control cohort resizes the cohort, which is incompatible "
                "with --keep-opt (the persisted inner optimizer state is "
                "(K, ...)-shaped)"
            )
        if straggler.deadline <= 0.0:
            raise SystemExit(
                "--control cohort needs a finite straggler deadline to tune: "
                "pick --straggler-profile mild/heavy or set --deadline"
            )
        policy = CohortTuner(
            clients_per_round=args.clients,
            deadline=straggler.deadline,
            population=args.population,
            target=args.control_target if args.control_target is not None else 0.9,
            gain=args.control_gain if args.control_gain is not None else 0.25,
        )
    return FederationController(policy, window=args.control_window,
                                interval=args.control_interval)


def _restore_controller(controller, manifest, latest):
    """Reconcile ``--control`` with the checkpoint's controller state; refuses
    a governed run resumed statically and the reverse."""
    ctrl_state = manifest.get("control") if isinstance(manifest, dict) else None
    if controller is None:
        if ctrl_state is not None:
            raise SystemExit(
                f"--resume: checkpoint round {latest} carries live "
                f"--control {ctrl_state.get('policy')} state but this run asked "
                f"for --control static — the knob trajectory would diverge; "
                f"resume with the original policy"
            )
        return None
    if ctrl_state is None:
        raise SystemExit(
            f"--resume: --control {controller.policy.name} requested but "
            f"checkpoint round {latest} was written without a controller — "
            f"resume with --control static or start fresh"
        )
    try:
        controller.load_state_dict(ctrl_state)
    except ValueError as e:
        raise SystemExit(f"--resume: {e}")
    return controller


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="photon-75m")
    ap.add_argument("--reduced", action="store_true", help="use the smoke-scale config")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=8, help="τ")
    ap.add_argument("--clients", type=int, default=4, help="K sampled per round")
    ap.add_argument("--population", type=int, default=8, help="P total clients")
    ap.add_argument("--batch", type=int, default=4, help="per-client batch size")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--heterogeneous", action="store_true", help="Pile-style partition")
    ap.add_argument("--outer", default="fedavg", choices=["fedavg", "fedmom", "fedadam"])
    ap.add_argument("--outer-lr", type=float, default=1.0)
    ap.add_argument("--inner-lr", type=float, default=3e-4)
    ap.add_argument("--keep-opt", action="store_true")
    ap.add_argument("--fedprox-mu", type=float, default=0.0)
    ap.add_argument("--dp-clip", type=float, default=0.0)
    ap.add_argument("--dp-noise", type=float, default=0.0)
    ap.add_argument("--pseudo-grad-dtype", default="float32",
                    help="legacy flat-cast uplink (float32 or bfloat16); superseded by --uplink")
    ap.add_argument("--uplink", default="float32", choices=list(UPLINK_SCHEMES),
                    help="pseudo-gradient uplink codec: float32 (identity), bf16 "
                         "stochastic-rounding cast, per-tensor int8, or top-k "
                         "sparsification with per-client error feedback")
    ap.add_argument("--topk-fraction", type=float, default=0.05,
                    help="--uplink topk: fraction of entries kept")
    ap.add_argument("--fused-server", action="store_true",
                    help="server step as one fused pass over the flat (C, N) delta "
                         "buffer, and the flat-buffer uplink codecs: CUDA kernels on "
                         "the card")
    ap.add_argument("--participation", default="uniform",
                    choices=["uniform", "dirichlet", "markov"])
    ap.add_argument("--dirichlet-alpha", type=float, default=0.3)
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--straggler-profile", default="none", choices=sorted(STRAGGLER_PROFILES))
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--partial-progress", action="store_true")
    ap.add_argument("--client-weighting", default="uniform", choices=["uniform", "examples"])
    ap.add_argument("--aggregation", default="sync", choices=["sync", "async"],
                    help="sync: deadline-masked federated rounds; async: FedBuff-style "
                         "buffered aggregation — stragglers land in later buffers with "
                         "staleness-discounted weights instead of being dropped")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="async: deltas per outer update (M); default max(1, K//2)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="async: staleness discount exponent in w/(1+s)^alpha")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="async: reject deltas older than this many server rounds "
                         "(0 = accept any age)")
    ap.add_argument("--cohort-tile", type=int, default=None,
                    help="sync: stream the cohort through the round in tiles of this many "
                         "clients (Σ w·Δ per tile, one divide), so the (C, N) delta buffer "
                         "is bounded by the tile; bitwise the flat round when the tile equals "
                         "--clients. Incompatible with --fused-server and --keep-opt")
    ap.add_argument("--robust-agg", default="none", choices=list(ROBUST_RULES),
                    help="Byzantine-robust aggregation rule: none (the weighted mean), "
                         "trimmed (coordinate-wise trimmed mean), median (coordinate-wise "
                         "median) or normclip (per-delta norm clipping before the mean)")
    ap.add_argument("--trim-fraction", type=float, default=0.1,
                    help="--robust-agg trimmed: fraction trimmed from EACH tail")
    ap.add_argument("--clip-mult", type=float, default=3.0,
                    help="--robust-agg normclip: threshold as a multiple of the cohort's "
                         "median delta norm (when --clip-norm is 0)")
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="--robust-agg normclip: absolute threshold (0 = from --clip-mult; "
                         "required > 0 with --cohort-tile)")
    ap.add_argument("--screen", action="store_true",
                    help="delta screen: non-finite deltas and norm outliers past "
                         "--screen-z robust z-scores weigh 0 (sync) or are refused at the "
                         "buffer door (async), and their senders are quarantined")
    ap.add_argument("--screen-z", type=float, default=6.0,
                    help="--screen: robust z-score threshold")
    ap.add_argument("--screen-warmup", type=int, default=8,
                    help="async --screen: admitted norms before the adaptive bound engages")
    ap.add_argument("--rollback", action="store_true",
                    help="divergence guard (requires --ckpt-dir): an update norm past "
                         "--rollback-factor × the trailing window's median, or non-finite, "
                         "restores params/outer from the last good checkpoint")
    ap.add_argument("--rollback-window", type=int, default=8,
                    help="--rollback: trailing update norms in the guard window")
    ap.add_argument("--rollback-factor", type=float, default=4.0,
                    help="--rollback: spike multiple over the window median that trips it")
    ap.add_argument("--quarantine-rounds", type=int, default=4,
                    help="rounds a screened or rolled-back client is excluded")
    ap.add_argument("--byzantine-fraction", type=float, default=0.0,
                    help="simulated attack (async): population clients below "
                         "floor(fraction·P) corrupt every delta they push")
    ap.add_argument("--byzantine-kind", default="scale",
                    choices=[k for k in CORRUPT_KINDS if k != "replay"],
                    help="what the --byzantine-fraction attackers send")
    ap.add_argument("--runtime", default="inproc", choices=["inproc", "sockets"],
                    help="inproc: the simulated single-process timeline; sockets: this "
                         "process is the aggregation server (--role server) or one client "
                         "worker (--role client) of a cross-process deployment. Requires "
                         "--aggregation async")
    ap.add_argument("--role", default="server", choices=["server", "client"],
                    help="--runtime sockets: which process this is")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="server: listen port (0 = pick a free one, printed at startup); "
                         "client: the server's port")
    ap.add_argument("--worker-id", default="worker-0",
                    help="--role client: this worker's name (lease bookkeeping)")
    ap.add_argument("--lease-timeout", type=float, default=30.0,
                    help="server: seconds before a granted but unreturned assignment is "
                         "redispatched to another worker")
    ap.add_argument("--io-timeout", type=float, default=30.0,
                    help="sockets: per-request socket timeout")
    ap.add_argument("--flush-deadline", type=float, default=None,
                    help="server: flush a partly filled buffer when the next in-order result "
                         "stalls this many seconds (default: wait — exact parity with inproc)")
    ap.add_argument("--chaos-drop", type=float, default=0.0,
                    help="fault injection: P(outbound message dropped)")
    ap.add_argument("--chaos-delay", type=float, default=0.0,
                    help="fault injection: P(outbound message delayed)")
    ap.add_argument("--chaos-kill", type=float, default=0.0,
                    help="fault injection: P(process hard-exits before a send)")
    ap.add_argument("--chaos-corrupt", type=float, default=0.0,
                    help="fault injection: P(a worker's push payload is poisoned before send)")
    ap.add_argument("--chaos-corrupt-kinds", default=",".join(CORRUPT_KINDS),
                    help="comma-separated corruption kinds --chaos-corrupt picks from "
                         f"(any of: {', '.join(CORRUPT_KINDS)})")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--control", default="static", choices=["static", "staleness", "cohort"],
                    help="closed-loop aggregation control: static (bitwise the uncontrolled "
                         "run); staleness (async) governs --staleness-alpha/--buffer-size "
                         "toward a target admitted-staleness quantile; cohort (sync) tunes "
                         "the straggler deadline and --clients from the effective-K fraction")
    ap.add_argument("--control-target", type=float, default=None,
                    help="the setpoint: admitted-staleness quantile in server rounds "
                         "(staleness, default 1.0) or effective-K fraction (cohort, 0.9)")
    ap.add_argument("--control-quantile", type=float, default=0.9,
                    help="--control staleness: the staleness quantile held at the target")
    ap.add_argument("--control-gain", type=float, default=None,
                    help="proportional gain (default 0.5 staleness / 0.25 cohort)")
    ap.add_argument("--control-window", type=int, default=4,
                    help="metric rows the controller aggregates per decision")
    ap.add_argument("--control-interval", type=int, default=1,
                    help="boundaries between control decisions")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append structured trace events to this JSONL file (under "
                         "--runtime sockets one path per process; merge with python -m "
                         "repro_torch.obs.report); tracing never changes a result")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text on 127.0.0.1:PORT/metrics (0 = a free port)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _refuse_uplink_dtype(args) -> None:
    if args.pseudo_grad_dtype not in ("float32", "bfloat16"):
        raise SystemExit(f"--pseudo-grad-dtype {args.pseudo_grad_dtype!r}: float32 or bfloat16")
    if args.uplink != "float32" and args.pseudo_grad_dtype != "float32":
        raise SystemExit(
            "--uplink and the legacy --pseudo-grad-dtype are mutually exclusive: "
            "the codec already defines the wire format"
        )


def _refuse_compositions(args):
    """The reference's refusals of flag combinations, in its order and
    wording; returns the robust config."""
    if args.runtime == "sockets" and args.aggregation != "async":
        raise SystemExit(
            "--runtime sockets requires --aggregation async: the socket server "
            "IS the buffered-aggregation event loop (docs/runtime.md)"
        )
    try:
        robust = _robust_from_args(args)
    except ValueError as e:
        raise SystemExit(f"--robust-agg: {e}")
    if robust is not None and args.rollback and not args.ckpt_dir:
        raise SystemExit(
            "--rollback restores the server from the last good checkpoint — "
            "it requires --ckpt-dir"
        )
    if robust is not None and robust.active and args.fused_server:
        raise SystemExit(
            "--robust-agg/--screen and --fused-server are mutually exclusive: "
            "the fused Pallas server path computes the plain weighted mean "
            "in one pass and has no robust-rule variant (docs/robustness.md)"
        )
    if robust is not None and args.cohort_tile:
        if robust.screen:
            raise SystemExit(
                "--screen needs the whole cohort's delta norms at once and "
                "cannot compose with --cohort-tile streaming; use "
                "--robust-agg trimmed/median (tiled per-coordinate folds) "
                "or normclip with an absolute --clip-norm"
            )
        if robust.rule == "normclip" and robust.clip_norm <= 0.0:
            raise SystemExit(
                "--robust-agg normclip under --cohort-tile needs an absolute "
                "--clip-norm: the median-derived threshold (--clip-mult) "
                "requires every cohort norm before any tile is folded"
            )
    if args.byzantine_fraction > 0.0 and (args.aggregation != "async"
                                          or args.runtime != "inproc"):
        raise SystemExit(
            "--byzantine-fraction is the in-process async attack simulator "
            "(the bench harness hook); under --runtime sockets inject payload "
            "corruption with --chaos-corrupt instead"
        )
    if args.aggregation == "async":
        if args.cohort_tile:
            raise SystemExit(
                "--cohort-tile applies to --aggregation sync only: the async "
                "path already streams one client delta at a time into the "
                "buffer, so its memory is bounded by the buffer size M, not "
                "the cohort"
            )
        if args.keep_opt:
            raise SystemExit(
                "--keep-opt with --aggregation async is not supported: async "
                "clients are stateless (paper §7.8) — a client's next dispatch "
                "may serve a different model version, so persisted inner Adam "
                "state would be silently stale"
            )
    return robust


def _roll_back(ckpt, agg, good: int) -> None:
    """Adopt the ``{params, outer}`` of checkpoint ``good``."""
    like = {"params": agg.state["params"], "outer": agg.state["outer"]}
    restored, _ = ckpt.load_server(good, like)
    agg.adopt_model(restored)


def _resume(args, agg, fed, pcfg, params, codec, streams, ckpt, controller):
    """Adopt the newest complete checkpoint; returns the next round to run."""
    latest = ckpt.latest_round()
    if latest is None:
        return 0
    manifest = ckpt.load_manifest(latest)
    extra = manifest.get("extra", {})
    agg_man = extra.get("aggregator")
    if agg_man is not None:
        if agg_man.get("kind") != "sync":
            # the sync template would load from an async npz (its keys are a
            # subset) and silently drop the buffer and the in-flight queue
            raise SystemExit(
                f"--resume: checkpoint round {latest} was written by a --aggregation "
                f"{agg_man.get('kind')} run; resuming it synchronously would silently drop "
                f"the buffer lanes and the in-flight dispatch queue — resume with the "
                f"original aggregation mode or start fresh"
            )
        try:
            SyncAggregator.validate_manifest(agg_man, "sync")
        except ValueError as e:
            raise SystemExit(f"--resume: {e}")
    ckpt_uplink = extra.get("args", {}).get("uplink", "float32")
    if get_codec(ckpt_uplink).stateful and not (codec is not None and codec.stateful):
        # load_pytree ignores npz keys the template lacks: without this check
        # the clients' accumulated residual mass would be dropped silently
        raise SystemExit(
            f"--resume: checkpoint round {latest} was written with --uplink "
            f"{ckpt_uplink} and carries per-client error-feedback residuals; resuming "
            f"with --uplink {args.uplink} would discard them — use the original codec "
            f"or start fresh"
        )
    # the residual lane is sized by the manifest's id list (sparse) or the
    # population (legacy dense): nothing population-sized is allocated here
    like = SyncAggregator.checkpoint_template(
        fed, pcfg, params, codec,
        uplink_ids=agg_man.get("uplink_ids") if isinstance(agg_man, dict) else None,
    )
    try:
        state, _ = ckpt.load_server(latest, like)
    except KeyError as e:
        raise SystemExit(
            f"--resume: checkpoint round {latest} does not carry the state this "
            f"run needs (missing {e}); resume with the original --outer/--keep-opt, "
            f"and error-feedback residuals only round-trip with the same --uplink codec"
        )
    controller = _restore_controller(
        controller, agg_man if isinstance(agg_man, dict) else {}, latest)
    if controller is not None:
        # the checkpoint may be mid-trajectory: the aggregator takes the
        # controller's current knobs, not the CLI's, before any round runs
        knobs = controller.knobs()
        agg.apply_knobs(KnobUpdate(clients_per_round=int(knobs["clients_per_round"]),
                                   deadline=knobs["deadline"]))
    agg.restore(state, agg_man)
    for i, s in enumerate(streams):
        try:
            s.load_state_dict(ckpt.load_client(latest, i))
        except FileNotFoundError:
            pass
    print(f"resumed from round {latest}")
    return latest + 1


def run(args, cfg=None) -> dict:
    _refuse_uplink_dtype(args)
    robust = _refuse_compositions(args)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len, args.seq_len))
    model = build_model(cfg)

    fed = FederatedConfig(
        clients_per_round=args.clients,
        local_steps=args.local_steps,
        inner=InnerOptConfig(
            lr_max=args.inner_lr,
            warmup_steps=max(1, args.rounds * args.local_steps // 20),
            total_steps=args.rounds * args.local_steps,
        ),
        outer=OuterOptConfig(name=args.outer, lr=args.outer_lr),
        keep_inner_state=args.keep_opt,
        fedprox_mu=args.fedprox_mu,
        dp_clip=args.dp_clip,
        dp_noise=args.dp_noise,
        pseudo_grad_dtype=args.pseudo_grad_dtype,
    )
    straggler = STRAGGLER_PROFILES[args.straggler_profile]
    if args.deadline is not None:
        straggler = dataclasses.replace(straggler, deadline=args.deadline)
    pcfg = ParticipationConfig(
        population=args.population,
        clients_per_round=args.clients,
        model=args.participation,
        dirichlet_alpha=args.dirichlet_alpha,
        dropout_rate=args.dropout_rate,
        straggler=straggler,
        weighting=args.client_weighting,
    )

    streams = build_client_streams(
        args.population, args.seq_len, cfg.vocab_size,
        heterogeneous=args.heterogeneous, seed=args.seed,
    )
    val_stream = validation_stream(args.seq_len, cfg.vocab_size, args.heterogeneous)
    params = model.init(args.seed, device=device)
    codec = (get_codec(args.uplink, args.topk_fraction, fused=args.fused_server)
             if args.uplink != "float32" else None)
    if args.aggregation == "async":
        if args.runtime == "sockets" and args.role == "client":
            return _run_worker(args, model, fed, pcfg, streams, codec, device)
        return _run_async(args, cfg, model, fed, pcfg, streams, val_stream, params, codec,
                          device, robust)

    tracer = _build_tracer(args, "server")
    controller = _build_controller(args, straggler=straggler)
    agg = SyncAggregator(
        model.loss, fed, pcfg, seed=args.seed, partial_progress=args.partial_progress,
        fused_server=args.fused_server, params=params, rng=prng_key(args.seed + 1),
        codec=codec, cohort_tile=args.cohort_tile, robust=robust, tracer=tracer,
        controller=controller,
    )
    metrics_srv = _start_metrics(args, tracer)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_round = (_resume(args, agg, fed, pcfg, params, codec, streams, ckpt, controller)
                   if ckpt and args.resume else 0)
    logger = MetricLogger(args.log) if args.log else None

    history = []
    try:
        _run_sync_rounds(args, model, agg, streams, val_stream, ckpt, logger, history,
                         start_round, params, codec, device, robust)
    finally:
        if metrics_srv is not None:
            metrics_srv.close()
        if tracer is not None:
            tracer.close()
    return {"history": history, "state": agg.state, "model": model, "config": cfg,
            "aggregator": agg}


def _run_sync_rounds(args, model, agg, streams, val_stream, ckpt, logger, history,
                     start_round, params, codec, device, robust):
    for rnd in range(start_round, args.rounds):
        t0 = time.perf_counter()
        plan = agg.plan(rnd)
        sel = plan.selected
        batches_np = round_batches([streams[i] for i in sel], args.local_steps, args.batch)
        batches = {k: torch.from_numpy(v).to(device) for k, v in batches_np.items()}
        metrics = agg.run_round(batches, plan)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
        metrics.update(
            round=rnd,
            selected=",".join(map(str, sel)),
            contributors=",".join(map(str, sel[plan.mask])),
            seconds=time.perf_counter() - t0,
            train_ppl=perplexity(metrics["train_loss"]),
            **participation_metrics(plan),
            **partial_progress_metrics(plan, args.local_steps),
            **uplink_round_metrics(args.uplink, params, plan.effective_k,
                                   args.topk_fraction, codec=codec),
        )
        val_ppl = evaluate_perplexity(
            model, agg.state["params"], val_stream, batches=args.eval_batches,
            batch_size=args.batch, device=device,
        )
        metrics["val_ppl"] = val_ppl
        history.append(metrics)
        partial = (
            f" tau={metrics['partial_tau_mean']:.2f} "
            f"rescued={metrics['partial_rescued_clients']:.0f}"
            if args.partial_progress else ""
        )
        print(
            f"round {rnd}: loss={metrics['train_loss']:.4f} val_ppl={val_ppl:.2f} "
            f"pg_norm={metrics['pseudo_grad_norm']:.4f} "
            f"consensus={metrics['client_consensus']:.3f} "
            f"eff_K={plan.effective_k}/{len(plan.selected)} "
            f"stragglers={plan.n_stragglers} dropped={plan.n_dropped}"
            f"{partial} [{metrics['seconds']:.1f}s]"
        )
        # the divergence guard sees this round's update norm before the
        # checkpoint is saved, so a poisoned round never becomes a resume point
        rs = agg.robust_state
        tripped = rolled_back = False
        if rs is not None and robust.rollback:
            metrics["rolled_back"] = 0.0
            tripped = rs.observe_update(metrics["pseudo_grad_norm"])
            if tripped:
                good = rs.last_good
                if good >= 0 and ckpt is not None:
                    _roll_back(ckpt, agg, good)
                    contributors = [int(c) for c in sel[plan.mask]]
                    rs.add_quarantine(contributors, rnd)
                    rs.note_rollback()
                    rolled_back = True
                    metrics["rolled_back"] = 1.0
                    if agg.tracer.enabled:
                        pg = metrics["pseudo_grad_norm"]
                        agg.tracer.point("rollback", round=rnd, restored_round=good,
                                         pg_norm=float(pg) if pg == pg else -1.0,
                                         quarantined=len(contributors))
                        agg.tracer.count("rollbacks")
                    print(f"  ROLLBACK: update norm {metrics['pseudo_grad_norm']:.4g} tripped "
                          f"the divergence guard — restored round {good}, quarantined "
                          f"{contributors} for {robust.quarantine_rounds} rounds")
                else:
                    print("  divergence guard tripped but no good checkpoint exists yet — "
                          "continuing without rollback")
        # the round boundary is the sync control point: the cohort tuner may
        # move the deadline and K for the next round (echoed into the row)
        update = agg.control_step(metrics)
        if update is not None:
            for k, v in update.knob_dict().items():
                metrics[f"knob_{k}"] = v
            print("  control: " + ", ".join(f"{k}={v:g}" for k, v in update.knob_dict().items()))
        if logger:
            logger.log(metrics)
        if ckpt:
            if rs is not None and (not tripped or rolled_back):
                # marked before checkpoint(), so the saved manifest's last_good
                # names this round, valid exactly when this checkpoint is complete
                rs.mark_good(rnd)
            tree, agg_manifest = agg.checkpoint()
            ckpt.save_server(rnd, tree, extra={"args": vars(args), "aggregator": agg_manifest})
            for i in range(args.population):
                ckpt.save_client(rnd, i, streams[i].state_dict())


# args whose value changes the dispatch timeline, the data every client draws
# or the optimizer/buffer semantics: an async resume with any of them altered
# would silently replay a different run (``--rounds`` alone may change). The
# reference's list.
_ASYNC_RESUME_ARGS = (
    "seed", "clients", "population", "local_steps", "batch", "buffer_size",
    "staleness_alpha", "max_staleness", "participation", "dirichlet_alpha",
    "dropout_rate", "straggler_profile", "deadline", "client_weighting",
    "uplink", "topk_fraction", "partial_progress", "fused_server",
    "arch", "reduced", "seq_len", "heterogeneous",
    "inner_lr", "outer", "outer_lr", "fedprox_mu",
    "dp_clip", "dp_noise", "pseudo_grad_dtype",
    "control", "control_target", "control_quantile", "control_gain",
    "control_window", "control_interval",
    "robust_agg", "trim_fraction", "clip_mult", "clip_norm",
    "screen", "screen_z", "screen_warmup",
    "rollback", "rollback_window", "rollback_factor", "quarantine_rounds",
    "byzantine_fraction", "byzantine_kind",
)

# the reference's defaults of the flags above that postdate older checkpoints
# or that this package does not have: a flag missing from a checkpoint ran
# with its default, and a flag missing here is its default
_REFERENCE_DEFAULTS = {
    "control": "static", "control_target": None, "control_quantile": 0.9,
    "control_gain": None, "control_window": 4, "control_interval": 1, "robust_agg": "none",
    "trim_fraction": 0.1, "clip_mult": 3.0, "clip_norm": 0.0, "screen_z": 6.0,
    "screen_warmup": 8, "rollback_window": 8, "rollback_factor": 4.0, "quarantine_rounds": 4,
    "byzantine_kind": "scale",
}


def _check_async_resume_args(args, ck_args: dict) -> None:
    for key in _ASYNC_RESUME_ARGS:
        ours = getattr(args, key, _REFERENCE_DEFAULTS.get(key))
        if key not in ck_args and (not ours or ours == _REFERENCE_DEFAULTS.get(key)):
            continue  # the checkpoint predates the flag and ran with its default
        theirs = ck_args.get(key)
        if (theirs is not None or ours is not None) and ours != theirs:
            raise SystemExit(
                f"--resume: --{key.replace('_', '-')}={ours} does not match the "
                f"checkpoint's {theirs} — the async timeline is pure in (config, seed), so "
                f"resuming under a different configuration would silently replay a "
                f"different run"
            )


def _run_worker(args, model, fed, pcfg, streams, codec, device) -> dict:
    """``--runtime sockets --role client``: one pure-compute worker. It builds
    the server's model and configs but owns no federation state: every
    assignment ships the params snapshot, the residual row, the codec key and
    the client's data cursor; its streams only receive cursors."""
    if args.partial_progress:
        pcfg = dataclasses.replace(pcfg, partial_progress=True, local_steps=args.local_steps)
    tracer = _build_tracer(args, args.worker_id)
    worker = ClientWorker(
        model.loss, fed, pcfg, streams=streams, batch_size=args.batch,
        host=args.host, port=args.port, codec=codec, name=args.worker_id,
        io_timeout=args.io_timeout, chaos=_chaos_from_args(args), tracer=tracer, device=device,
    )
    metrics_srv = _start_metrics(args, tracer)
    print(f"worker {args.worker_id} serving {args.host}:{args.port}")
    try:
        n = worker.run()
    finally:
        if metrics_srv is not None:
            metrics_srv.close()
        if tracer is not None:
            tracer.close()
    print(f"worker {args.worker_id} done after {n} assignments")
    return {"completed": n, "worker": worker}


def _run_async(args, cfg, model, fed, pcfg, streams, val_stream, params, codec, device,
               robust=None) -> dict:
    """Event-driven FedBuff-style training: K busy client slots, a server-side
    delta buffer, one outer update per ``--buffer-size`` admitted deltas.
    Every update checkpoints the aggregator's schema (buffer lanes, residual
    rows, in-flight snapshots, dispatch cursor), so ``--resume`` replays the
    timeline from it bitwise."""
    acfg = AsyncAggConfig(
        buffer_size=(args.buffer_size if args.buffer_size is not None
                     else max(1, args.clients // 2)),
        staleness_alpha=args.staleness_alpha,
        max_staleness=args.max_staleness,
    )
    if args.partial_progress:
        # the deadline becomes a per-dispatch budget: plan_round derives τ_i and
        # the aggregator admits partial deltas at the fractional τ_i/τ weight
        pcfg = dataclasses.replace(pcfg, partial_progress=True, local_steps=args.local_steps)
    controller = _build_controller(args, acfg=acfg)

    def make_batches(cid):
        b = round_batches([streams[cid]], args.local_steps, args.batch)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    logger = MetricLogger(args.log) if args.log else None
    state = dispatch = None
    start_update = deltas_resumed = 0
    if args.resume:
        if ckpt is None:
            raise SystemExit("--resume with --aggregation async needs --ckpt-dir")
        latest = ckpt.latest_round()
        if latest is not None:
            extra = ckpt.load_manifest(latest).get("extra", {})
            dispatch = extra.get("aggregator")
            if not isinstance(dispatch, dict) or dispatch.get("kind") != "async":
                raise SystemExit(
                    f"--resume: checkpoint round {latest} carries no async aggregator "
                    f"manifest (written by a sync run, or before the resumable schema) — "
                    f"the in-flight dispatch queue cannot be replayed; start fresh"
                )
            try:
                AsyncBufferAggregator.validate_manifest(dispatch, "async")
            except ValueError as e:
                raise SystemExit(f"--resume: {e}")
            _check_async_resume_args(args, extra.get("args", {}))
            controller = _restore_controller(controller, dispatch, latest)
            if controller is not None:
                # the buffer lanes in the checkpoint have the controller's M
                knobs = controller.knobs()
                acfg = dataclasses.replace(acfg, staleness_alpha=float(knobs["staleness_alpha"]),
                                           buffer_size=int(knobs["buffer_size"]))
            like = AsyncBufferAggregator.checkpoint_template(
                fed, acfg, pcfg, params, codec, uplink_ids=dispatch.get("uplink_ids"))
            state, _ = ckpt.load_server(latest, like)
            start_update = latest + 1
            deltas_resumed = int(extra.get("train", {}).get("deltas_admitted", 0))
            for i, s in enumerate(streams):
                try:
                    s.load_state_dict(ckpt.load_client(latest, i))
                except FileNotFoundError:
                    pass
            print(f"resumed async run from update {latest} (dispatch cursor "
                  f"{dispatch['cursor']}, sim_time {dispatch['sim_time']:.2f})")

    tracer = _build_tracer(args, "server")
    backend = None
    common = dict(seed=args.seed, params=params, rng=prng_key(args.seed + 1), codec=codec,
                  state=state, dispatch=dispatch, fused_server=args.fused_server,
                  robust=robust, tracer=tracer, controller=controller)
    if args.runtime == "sockets":
        # the server owns every client's data cursor: it ships with each
        # assignment and the advanced one is committed in event order, so the
        # checkpointed cursors agree with the dispatch manifest
        backend = SocketBackend(
            host=args.host, port=args.port, stream_states=[s.state_dict() for s in streams],
            lease_timeout=args.lease_timeout, io_timeout=args.io_timeout,
            chaos=_chaos_from_args(args), tracer=tracer, device=device,
        )
        print(f"server listening on {backend.host}:{backend.port}", flush=True)
        driver = FederationDriver(backend, fed, acfg, pcfg, flush_deadline=args.flush_deadline,
                                  **common)
    else:
        driver = AsyncFederationDriver(model.loss, fed, acfg, pcfg, make_batches, **common)
        # the in-process attack simulator: the lowest population ids corrupt every upload
        driver.corrupt_fn = make_byzantine_fn(args.byzantine_fraction, args.byzantine_kind,
                                              args.population)
    metrics_srv = _start_metrics(
        args, tracer, extra=(backend.metrics_extras if backend is not None else None))

    # what the deadline-masking sync schedule pays to aggregate as many deltas
    sync_cum = [(0.0, 0)]  # (cumulative sim time, cumulative aggregated deltas)

    def sync_equiv_time(n_deltas: int) -> float:
        while sync_cum[-1][1] < n_deltas and len(sync_cum) < 100_000:
            plan = plan_round(pcfg, args.seed, len(sync_cum) - 1)
            t, d = sync_cum[-1]
            sync_cum.append((t + plan.round_time, d + plan.effective_k))
        return sync_cum[-1][0] if sync_cum[-1][1] >= n_deltas else float("inf")

    history = []
    deltas_admitted = [deltas_resumed]
    t_wall = [time.perf_counter()]

    def on_update(i, row):
        u = start_update + i  # the outer-update index across resumes
        staleness = row.pop("admitted_staleness", [])
        row.update((k, v) for k, v in staleness_stats(staleness).items()
                   if k.startswith("staleness_hist_"))
        deltas_admitted[0] += int(row.get("buffer_fill", 0))
        row.update(uplink_round_metrics(args.uplink, params, row.get("buffer_fill", 0.0),
                                        args.topk_fraction, codec=codec))
        row.update(
            update=u,
            round=u,
            deltas_admitted=float(deltas_admitted[0]),
            wallclock_speedup=wallclock_speedup(sync_equiv_time(deltas_admitted[0]),
                                                row["sim_time"]),
            work_completed=driver.work_completed,
            work_wasted=driver.work_wasted,
            seconds=time.perf_counter() - t_wall[0],
            train_loss=row["train_loss_mean"],
            train_ppl=perplexity(row["train_loss_mean"]),
        )
        t_wall[0] = time.perf_counter()
        row["val_ppl"] = evaluate_perplexity(
            model, driver.state["params"], val_stream, batches=args.eval_batches,
            batch_size=args.batch, device=device,
        )
        history.append(row)
        print(
            f"update {u}: loss={row['train_loss_mean']:.4f} val_ppl={row['val_ppl']:.2f} "
            f"pg_norm={row['pseudo_grad_norm']:.4f} "
            f"staleness={row['staleness_mean']:.2f}/{row['staleness_max']:.0f} "
            f"buf={row['buffer_fill']:.0f}/{driver.acfg.buffer_size} "
            f"t_sim={row['sim_time']:.2f} speedup={row['wallclock_speedup']:.2f}x "
            f"[{row['seconds']:.1f}s]"
        )
        knobs = {k[len("knob_"):]: v for k, v in row.items() if k.startswith("knob_")}
        if knobs:
            print("  control: " + ", ".join(f"{k}={v:g}" for k, v in knobs.items()))
        # the async guard: a spiking flush norm rolls the server back to the
        # last good update and drains the buffer; no one is quarantined (the
        # flush mixes many senders — repeat offenders are the door's job)
        rs = driver.robust_state
        tripped = rolled_back = False
        if rs is not None and robust.rollback:
            row["rolled_back"] = 0.0
            tripped = rs.observe_update(row["pseudo_grad_norm"])
            if tripped:
                good = rs.last_good
                if good >= 0 and ckpt is not None:
                    _roll_back(ckpt, driver, good)
                    rs.note_rollback()
                    rolled_back = True
                    row["rolled_back"] = 1.0
                    if driver.tracer.enabled:
                        driver.tracer.point("rollback", round=u, restored_round=good)
                        driver.tracer.count("rollbacks")
                    print(f"  ROLLBACK: flush norm tripped the divergence guard — restored "
                          f"update {good} (buffer drained)")
                else:
                    print("  divergence guard tripped but no good checkpoint exists yet — "
                          "continuing without rollback")
        if logger:
            logger.log(row)
        if ckpt:
            if rs is not None and (not tripped or rolled_back):
                rs.mark_good(u)
            tree, agg_manifest = driver.checkpoint()
            ckpt.save_server(u, tree, extra={
                "args": vars(args), "aggregator": agg_manifest,
                "train": {"deltas_admitted": deltas_admitted[0]}, "sim_time": row["sim_time"],
            })
            # the cursors' source of truth: the streams in process, the
            # backend's committed cursors under sockets
            cursors = (backend.snapshot_stream_states() if backend is not None
                       else [streams[ci].state_dict() for ci in range(args.population)])
            for ci, cur in enumerate(cursors):
                ckpt.save_client(u, ci, cur)

    try:
        if args.rounds > start_update:
            driver.run_updates(args.rounds - start_update, on_update=on_update)
        else:
            print(f"nothing to do: checkpoint already at update {start_update - 1} "
                  f"of {args.rounds}")
    finally:
        driver.finalize_trace()  # close the in-flight dispatch spans (no-op untraced)
        if backend is not None:
            backend.close(linger=1.0)  # let the workers pull the "done" answer
        if metrics_srv is not None:
            metrics_srv.close()
        if tracer is not None:
            tracer.close()
    return {"history": history, "state": driver.state, "model": model, "config": cfg,
            "driver": driver}


def main() -> None:
    run(parse_args())


if __name__ == "__main__":
    main()
