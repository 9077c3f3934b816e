"""Federated pre-training driver, the synchronous path of ``repro.launch.train``
in PyTorch: reproducible client sampling, per-round stream binding, local
training, the server step, held-out validation, the CSV log and
checkpoint/auto-resume. Checkpoints are the reference's format: a run of
either package resumes the other's.

``--fused-server`` runs the server step (weighted mean + DP noise + outer
update + its norms) as one pass over the flat ``(C, N)`` delta buffer — on the
card, the hand-written CUDA ``server_apply`` kernel. The run is on ``cuda``
unless ``--device cpu`` is given; asking for cuda where there is none is an
error, never a silent fall back.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch photon-75m --fused-server
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --local-steps 2 --clients 2 --population 4 --seq-len 64 --device cpu

Not ported yet, and refused (see ROADMAP.md): ``--aggregation async`` and any
``--uplink`` other than float32. The socket runtime, the control loop, robust
aggregation, cohort tiles and tracing have no flags here.
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
    FederatedConfig,
    InnerOptConfig,
    OuterOptConfig,
    ParticipationConfig,
    SyncAggregator,
    prng_key,
)
from repro_torch.data import build_client_streams, round_batches, validation_stream
from repro_torch.metrics import (
    MetricLogger,
    evaluate_perplexity,
    partial_progress_metrics,
    participation_metrics,
    perplexity,
    uplink_round_metrics,
)
from repro_torch.models import build_model


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; cuda without a visible card is an error."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch sees no CUDA device")
    return torch.device(name)


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
                    help="legacy flat-cast uplink (float32 or bfloat16)")
    ap.add_argument("--uplink", default="float32",
                    choices=["float32", "bf16", "int8", "topk"],
                    help="pseudo-gradient uplink codec; only float32 is ported")
    ap.add_argument("--fused-server", action="store_true",
                    help="server step as one fused pass over the flat (C, N) delta "
                         "buffer: the CUDA server_apply kernel on the card")
    ap.add_argument("--participation", default="uniform",
                    choices=["uniform", "dirichlet", "markov"])
    ap.add_argument("--dirichlet-alpha", type=float, default=0.3)
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--straggler-profile", default="none", choices=sorted(STRAGGLER_PROFILES))
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--partial-progress", action="store_true")
    ap.add_argument("--client-weighting", default="uniform", choices=["uniform", "examples"])
    ap.add_argument("--aggregation", default="sync", choices=["sync", "async"],
                    help="only sync is ported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.aggregation != "sync":
        raise SystemExit("--aggregation async is not ported yet (ROADMAP.md queue A)")
    if args.uplink != "float32":
        raise SystemExit(
            f"--uplink {args.uplink} is not ported yet: the codecs come with the "
            f"next slice (ROADMAP.md queue A)"
        )
    if args.pseudo_grad_dtype not in ("float32", "bfloat16"):
        raise SystemExit(f"--pseudo-grad-dtype {args.pseudo_grad_dtype!r}: float32 or bfloat16")


def _resume(args, agg, fed, params, streams, ckpt):
    """Adopt the newest complete checkpoint; returns the next round to run."""
    latest = ckpt.latest_round()
    if latest is None:
        return 0
    manifest = ckpt.load_manifest(latest)
    extra = manifest.get("extra", {})
    agg_man = extra.get("aggregator")
    if agg_man is not None:
        for key in ("control", "robust", "uplink_ids"):
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
    if ckpt_uplink != "float32":
        raise SystemExit(
            f"--resume: checkpoint round {latest} was written with --uplink "
            f"{ckpt_uplink}, which is not ported yet (ROADMAP.md)"
        )
    like = SyncAggregator.checkpoint_template(fed, params)
    try:
        state, _ = ckpt.load_server(latest, like)
    except KeyError as e:
        raise SystemExit(
            f"--resume: checkpoint round {latest} does not carry the state this "
            f"run needs (missing {e}); resume with the original --outer/--keep-opt"
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

    agg = SyncAggregator(
        model.loss, fed, pcfg, seed=args.seed, partial_progress=args.partial_progress,
        fused_server=args.fused_server, params=params, rng=prng_key(args.seed + 1),
    )
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_round = _resume(args, agg, fed, params, streams, ckpt) if ckpt and args.resume else 0
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
            **uplink_round_metrics(params, plan.effective_k),
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


def main() -> None:
    run(parse_args())


if __name__ == "__main__":
    main()
