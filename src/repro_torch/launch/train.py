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
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --local-steps 2 --clients 2 --population 4 --seq-len 64 --device cpu

Not ported yet, and refused when set (see ROADMAP.md queue A): ``--cohort-tile``,
the robust flags (``--robust-agg``, ``--screen``, ``--rollback``,
``--byzantine-*``), ``--control`` and ``--runtime sockets``. Tracing has no
flag here.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import (
    STRAGGLER_PROFILES,
    UPLINK_SCHEMES,
    AsyncAggConfig,
    AsyncBufferAggregator,
    AsyncFederationDriver,
    FederatedConfig,
    InnerOptConfig,
    OuterOptConfig,
    ParticipationConfig,
    SyncAggregator,
    get_codec,
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


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; cuda without a visible card is an error."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch sees no CUDA device")
    return torch.device(name)


#: the reference's flags whose subsystems are not ported, as the reference
#: parses them, with the ROADMAP.md queue A item that ports each: each is
#: refused unless it has the reference's default (``--cohort-tile`` in either
#: aggregation mode)
_UNPORTED_FLAGS = (
    ("--cohort-tile", dict(type=int, default=None), 3),
    ("--robust-agg", dict(default="none", choices=["none", "trimmed", "median", "normclip"]), 4),
    ("--screen", dict(action="store_true"), 4),
    ("--rollback", dict(action="store_true"), 4),
    ("--byzantine-fraction", dict(type=float, default=0.0), 4),
    ("--byzantine-kind", dict(default="scale", choices=["nan", "inf", "scale", "sign_flip"]), 4),
    ("--control", dict(default="static", choices=["static", "staleness", "cohort"]), 5),
    ("--runtime", dict(default="inproc", choices=["inproc", "sockets"]), 6),
)


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
    for flag, spec, item in _UNPORTED_FLAGS:
        ap.add_argument(flag, **spec, help=f"not ported: refused unless left at its "
                                           f"default (ROADMAP.md queue A item {item})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.aggregation == "async" and args.keep_opt:
        raise SystemExit(
            "--keep-opt with --aggregation async is not supported: async clients are "
            "stateless (paper §7.8) — a client's next dispatch may serve a different "
            "model version, so persisted inner Adam state would be silently stale"
        )
    for flag, spec, item in _UNPORTED_FLAGS:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != spec.get("default", False):
            raise SystemExit(f"{flag} {value} is not ported yet (ROADMAP.md queue A item {item})")
    if args.pseudo_grad_dtype not in ("float32", "bfloat16"):
        raise SystemExit(f"--pseudo-grad-dtype {args.pseudo_grad_dtype!r}: float32 or bfloat16")
    if args.uplink != "float32" and args.pseudo_grad_dtype != "float32":
        raise SystemExit(
            "--uplink and the legacy --pseudo-grad-dtype are mutually exclusive: "
            "the codec already defines the wire format"
        )


def _resume(args, agg, fed, pcfg, params, codec, streams, ckpt):
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
        for key in ("control", "robust"):
            if key in agg_man:
                raise SystemExit(
                    f"--resume: checkpoint round {latest} carries {key!r} state, "
                    f"which this package does not port yet (ROADMAP.md)"
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
    agg.restore(state, agg_man)
    for i, s in enumerate(streams):
        try:
            s.load_state_dict(ckpt.load_client(latest, i))
        except FileNotFoundError:
            pass
    print(f"resumed from round {latest}")
    return latest + 1


def run(args, cfg=None) -> dict:
    _refuse_unported(args)
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
        return _run_async(args, cfg, model, fed, pcfg, streams, val_stream, params, codec,
                          device)

    agg = SyncAggregator(
        model.loss, fed, pcfg, seed=args.seed, partial_progress=args.partial_progress,
        fused_server=args.fused_server, params=params, rng=prng_key(args.seed + 1),
        codec=codec,
    )
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_round = (_resume(args, agg, fed, pcfg, params, codec, streams, ckpt)
                   if ckpt and args.resume else 0)
    logger = MetricLogger(args.log) if args.log else None

    history = []
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
        if logger:
            logger.log(metrics)
        if ckpt:
            tree, agg_manifest = agg.checkpoint()
            ckpt.save_server(rnd, tree, extra={"args": vars(args), "aggregator": agg_manifest})
            for i in range(args.population):
                ckpt.save_client(rnd, i, streams[i].state_dict())

    return {"history": history, "state": agg.state, "model": model, "config": cfg,
            "aggregator": agg}


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


def _run_async(args, cfg, model, fed, pcfg, streams, val_stream, params, codec, device
               ) -> dict:
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
            for key in ("control", "robust"):
                if key in dispatch:
                    raise SystemExit(
                        f"--resume: checkpoint round {latest} carries {key!r} state, which "
                        f"this package does not port yet (ROADMAP.md)"
                    )
            try:
                AsyncBufferAggregator.validate_manifest(dispatch, "async")
            except ValueError as e:
                raise SystemExit(f"--resume: {e}")
            _check_async_resume_args(args, extra.get("args", {}))
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

    driver = AsyncFederationDriver(
        model.loss, fed, acfg, pcfg, make_batches, seed=args.seed, params=params,
        rng=prng_key(args.seed + 1), codec=codec, state=state, dispatch=dispatch,
        fused_server=args.fused_server,
    )

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
        if logger:
            logger.log(row)
        if ckpt:
            tree, agg_manifest = driver.checkpoint()
            ckpt.save_server(u, tree, extra={
                "args": vars(args), "aggregator": agg_manifest,
                "train": {"deltas_admitted": deltas_admitted[0]}, "sim_time": row["sim_time"],
            })
            for ci in range(args.population):
                ckpt.save_client(u, ci, streams[ci].state_dict())

    if args.rounds > start_update:
        driver.run_updates(args.rounds - start_update, on_update=on_update)
    else:
        print(f"nothing to do: checkpoint already at update {start_update - 1} "
              f"of {args.rounds}")
    return {"history": history, "state": driver.state, "model": model, "config": cfg,
            "driver": driver}


def main() -> None:
    run(parse_args())


if __name__ == "__main__":
    main()
