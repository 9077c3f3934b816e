"""Dry run of every (architecture × input shape) on a mesh, the counterpart of
``repro.launch.dryrun``.

``--mesh production`` (the default, the reference's behaviour) builds each
step's plan against the production meshes — single pod (16, 16) = 256 H100s
and multi-pod (2, 16, 16) = 512 — on any host: meta tensors with their
PartitionSpecs, no memory and no compile. It prints the client mapping,
micro-batching, per-device argument bytes and model FLOPs of each plan, and
writes its report JSON with the terms only a run can give left null: the port
has no compile that spans cards, so it never estimates them.

``--mesh host`` runs each step on the one-card host mesh (``--device``, the
card by default). A step whose plan needs more argument bytes than the card
holds is refused before anything is allocated (a ``FAIL`` line); every other
step is materialized from seed 0, run once under the op counter and once
timed, and reported from the run: peak memory, counted FLOPs and bytes, the
roofline terms (``roofline/analysis``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch assigned --shape all --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh host --arch mamba2-1.3b \\
      --shape decode_32k,long_500k
"""
import argparse
import gc
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.core.compression import UPLINK_SCHEMES
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import arg_bytes_per_device, build_step, materialize
from repro_torch.roofline.analysis import analyze_compiled, measure


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="assigned", help="arch id | 'assigned' | comma list")
    ap.add_argument("--shape", default="all", help="shape name | 'all' | comma list")
    ap.add_argument("--multi-pod", default="no", choices=["no", "yes", "both"])
    ap.add_argument("--tau-lowered", type=int, default=4)
    ap.add_argument("--train-mode", default="federated",
                    choices=["federated", "centralized", "both"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-elastic", action="store_true",
                    help="drop the (C,) participation-weight input from the "
                         "federated round (legacy flat-mean round)")
    ap.add_argument("--pseudo-grad-dtype", default="float32")
    ap.add_argument("--uplink", default="float32", choices=list(UPLINK_SCHEMES),
                    help="compressed-uplink codec for the federated round: the "
                         "encoded-delta dtypes are carried through the plan "
                         "(residual inputs sharded like the client axis)")
    ap.add_argument("--topk-fraction", type=float, default=0.05)
    ap.add_argument("--partial-progress", action="store_true",
                    help="thread the (C,) straggler partial-progress τ-mask "
                         "through the federated round (a replicated int32 input)")
    ap.add_argument("--fused-server", action="store_true",
                    help="request the fused flat-buffer server phase "
                         "(kernels/fedcore). On a multi-device mesh the plan "
                         "keeps the reference phase (the fused kernel is the "
                         "aggregator-host path); on the host mesh it launches "
                         "server_apply")
    ap.add_argument("--cohort-tile", type=int, default=None,
                    help="plan the federated step as ONE TILE of a streamed "
                         "cohort (run_client_tile, client width = tile): the "
                         "population/cohort sizes never enter the plan")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="", help="suffix for result filenames (perf iters)")
    ap.add_argument("--mesh", default="production", choices=["production", "host"],
                    help="production: plans on the 256- and 512-card meshes, "
                         "nothing allocated; host: run each step on this "
                         "host's one-card mesh and report the measured run")
    ap.add_argument("--device", default="cuda",
                    help="the host mesh's device (--mesh host only): the card "
                         "by default, cpu for a CPU smoke")
    return ap.parse_args(argv)


def _train_kwargs(args, mode):
    return dict(
        tau_lowered=args.tau_lowered,
        remat=not args.no_remat,
        mode=mode,
        pseudo_grad_dtype=args.pseudo_grad_dtype,
        elastic=not args.no_elastic,
        uplink=args.uplink,
        topk_fraction=args.topk_fraction,
        partial_progress=args.partial_progress,
        fused_server=args.fused_server,
        cohort_tile=args.cohort_tile,
    )


def _plan(tag, step, mesh, chips, plan_bytes, extra) -> dict:
    print(f"== {tag} ==")
    meta = step.meta
    print(f"  plan: clients={meta.get('clients', '-')} client_axes={meta.get('client_axes', '-')} "
          f"fsdp_axes={meta.get('fsdp_axes', '-')} grad_accum={meta.get('grad_accum', '-')}")
    print(f"  arguments per device: {plan_bytes} bytes ({plan_bytes / 1e9:.3f} GB); "
          f"model_flops={step.model_flops:.3e}")
    return analyze_compiled(tag, None, chips, model_flops=step.model_flops, extra=extra)


def _run(tag, step, device, extra):
    """Materialize, run counted and timed; the reference's report lines."""
    args = materialize(step, device, seed=0)
    m = measure(step.fn, args, device)
    del args
    report = analyze_compiled(tag, m, step.mesh.size, model_flops=step.model_flops,
                              extra=extra)
    print(f"  memory_analysis: peak_bytes={m.peak_memory} "
          f"argument_bytes={extra['arg_bytes_per_device']} (measured on {device})")
    print("  cost_analysis: flops=%.3e bytes=%.3e (counted over %d aten ops)"
          % (m.flops, m.bytes, m.ops))
    print("  roofline: compute=%.4fs memory=%.4fs collective=%.4fs -> %s"
          % (report.t_compute, report.t_memory, report.t_collective, report.bottleneck))
    print(f"  collectives: {report.collective_counts}")
    print(f"  measured: seconds={m.seconds:.4f} kernels_not_counted={m.kernels_not_counted}")
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    archs = ASSIGNED_ARCHS if args.arch == "assigned" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    host = args.mesh == "host"
    pods = [False] if host else {"no": [False], "yes": [True],
                                 "both": [False, True]}[args.multi_pod]
    host_mesh = make_host_mesh(device=args.device) if host else None
    os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            ok, why = cfg.supports_shape(shape_name)
            if not ok:
                print(f"SKIP  {arch} x {shape_name}: {why}")
                continue
            if INPUT_SHAPES[shape_name].kind == "train":
                modes = {"federated": ["federated"], "centralized": ["centralized"],
                         "both": ["federated", "centralized"]}[args.train_mode]
            else:
                modes = [None]
            for multi_pod in pods:
                mesh = host_mesh if host else make_production_mesh(multi_pod=multi_pod)
                chips = mesh.size
                for mode in modes:
                    where = "host" if host else ("pod2" if multi_pod else "pod1")
                    tag = f"{arch}__{shape_name}__{where}"
                    if mode:
                        tag += f"__{mode}"
                    if args.tag:
                        tag += f"__{args.tag}"
                    t0 = time.perf_counter()
                    try:
                        kw = {}
                        if INPUT_SHAPES[shape_name].kind == "train":
                            kw = _train_kwargs(args, mode)
                        step = build_step(cfg, shape_name, mesh, **kw)
                        plan_bytes = arg_bytes_per_device(step)
                        extra = {"meta": step.meta, "arch": arch, "shape": shape_name,
                                 "multi_pod": multi_pod, "mode": mode or "serve",
                                 "mesh": args.mesh, "arg_bytes_per_device": plan_bytes,
                                 "hbm_bytes": mesh.hbm_bytes,
                                 "plan_s": time.perf_counter() - t0}
                        if not host:
                            report = _plan(tag, step, mesh, chips, plan_bytes, extra)
                            print(f"  not compiled: {chips} chips")
                        elif plan_bytes > mesh.hbm_bytes:
                            n_fail += 1
                            print(f"FAIL  {tag}: its arguments need {plan_bytes} bytes, "
                                  f"the device holds {int(mesh.hbm_bytes)}; not allocated")
                            continue
                        else:
                            print(f"== {tag} ==")
                            t1 = time.perf_counter()
                            report = _run(tag, step, mesh.device, extra)
                            report.extra["run_s"] = time.perf_counter() - t1
                        with open(os.path.join(args.out, tag + ".json"), "w") as f:
                            json.dump(report.to_dict(), f, indent=2, default=str)
                    except Exception:
                        n_fail += 1
                        print(f"FAIL  {tag}")
                        traceback.print_exc()
                    finally:
                        if host:
                            gc.collect()
                            if mesh.device.type == "cuda":
                                torch.cuda.empty_cache()
                        print(f"  [{time.perf_counter() - t0:.1f}s]", flush=True)

    print(f"\ndone; failures: {n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
