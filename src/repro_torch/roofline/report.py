"""Render the dry-run and roofline tables from results/dryrun/*.json, the
counterpart of ``repro.roofline.report``: one row per report that
``launch/dryrun`` wrote. A term a plan cannot know (null in the JSON) renders
as "-", and the mesh column reads the row's own mesh (host, 16x16,
2x16x16)."""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = [
    "granite-3-2b", "qwen3-1.7b", "mamba2-1.3b", "jamba-v0.1-52b", "deepseek-moe-16b",
    "llama4-scout-17b-a16e", "whisper-large-v3", "chameleon-34b", "deepseek-coder-33b",
    "gemma3-4b",
]


def load(results_dir: str, tag_filter: str = "", include_tagged: bool = False) -> List[Dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        name = os.path.basename(p)[: -len(".json")]
        parts = name.split("__")
        is_tagged = len(parts) > 4 or (len(parts) == 4 and parts[3] not in ("federated", "centralized"))
        if is_tagged and not include_tagged:
            continue
        with open(p) as f:
            r = json.load(f)
        r["_file"] = os.path.basename(p)
        if tag_filter and tag_filter not in r["_file"]:
            continue
        rows.append(r)
    return rows


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _key(r):
    a = r.get("arch", "")
    s = r.get("shape", "")
    return (
        ARCH_ORDER.index(a) if a in ARCH_ORDER else 99,
        SHAPE_ORDER.index(s) if s in SHAPE_ORDER else 99,
        r.get("multi_pod", False),
        r.get("mode", ""),
    )


def fmt_seconds(s) -> str:
    return "-" if s is None else f"{s:.4f}s"


def mesh_name(r: Dict) -> str:
    if r.get("mesh") == "host":
        return "host"
    return "2x16x16" if r.get("multi_pod") else "16x16"


def _plan_run(r: Dict) -> str:
    """Seconds to build the plan, and to run it where it ran."""
    out = f"{r.get('plan_s', 0):.1f}s"
    return out if r.get("run_s") is None else f"{out} / {r['run_s']:.1f}s"


def dryrun_table(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | mesh | mode | per-dev peak mem | per-dev args | plan / run "
        "| collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=_key):
        colls = " ".join(f"{k}:{int(v)}"
                         for k, v in sorted((r.get("collective_counts") or {}).items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {mesh_name(r)} | {r.get('mode', 'serve')} "
            f"| {fmt_bytes(r.get('peak_memory_per_device'))} "
            f"| {fmt_bytes(r.get('arg_bytes_per_device'))} "
            f"| {_plan_run(r)} | {colls or '-'} |"
        )
    return "\n".join(out)


def roofline_table(rows: List[Dict], single_pod_only: bool = True) -> str:
    out = [
        "| arch | shape | mesh | mode | t_compute | t_memory | t_collective | bottleneck "
        "| 6·N_act·D | useful-FLOP ratio |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=_key):
        if single_pod_only and r.get("multi_pod"):
            continue
        ratio = r.get("useful_flops_ratio")
        mf = r.get("model_flops")
        bn = r.get("bottleneck")
        out.append(
            f"| {r['arch']} | {r['shape']} | {mesh_name(r)} | {r.get('mode', 'serve')} "
            f"| {fmt_seconds(r.get('t_compute_s'))} | {fmt_seconds(r.get('t_memory_s'))} "
            f"| {fmt_seconds(r.get('t_collective_s'))} | {f'**{bn}**' if bn else '-'} "
            f"| {'-' if mf is None else f'{mf:.2e}'} "
            f"| {'-' if ratio is None else f'{ratio:.2f}'} |"
        )
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--which", default="both", choices=["dryrun", "roofline", "both"])
    args = ap.parse_args()
    rows = load(args.dir)
    if args.which in ("dryrun", "both"):
        print("### Dry-run table\n")
        print(dryrun_table(rows))
        print()
    if args.which in ("roofline", "both"):
        print("### Roofline table (host and single-pod 16x16)\n")
        print(roofline_table(rows))


if __name__ == "__main__":
    main()
