"""A real 3-process federated run on localhost, the port of
``examples/socket_federation.py``: 1 aggregation server + 2 client workers,
each a separate ``repro_torch.launch.train`` process speaking the
length-prefixed socket protocol (the reference's bytes).

Four demos, each an end-to-end assertion:

  --demo round        1 server + 2 workers run a top-k-compressed async run
                      to completion, then the SAME configuration runs
                      in-process (``--runtime inproc``) and the final
                      server.npz checkpoints are compared BITWISE — the
                      socket deployment is the simulator, byte for byte.
  --demo kill-resume  the server is SIGKILLed after its first completed
                      checkpoint; a fresh server process resumes from disk
                      and finishes the run. The final checkpoint must match
                      an uninterrupted in-process run bitwise.
  --demo chaos        workers roll seeded dice that drop/delay frames and
                      hard-kill the process mid-protocol (``--chaos-*``); the
                      supervisor respawns killed workers (exit code 137) and
                      the run must still complete with a finite loss.
  --demo corrupt      one worker poisons most of its delta payloads with
                      NaN/Inf (``--chaos-corrupt``: frames stay CRC-valid, so
                      only the server's ``--screen`` door stands); the run
                      must converge on the honest worker's pushes and the
                      merged trace must show a ``screen_reject`` for the
                      poison (``report --check --expect-faults``).

Every process runs on ``--device`` (the card by default). ``--fused-server``
hands every process the train CLI's switch of that name: the workers' top-k
uplink runs the CUDA ``topk_mask_ef`` kernel and the server's flush the
``server_apply`` kernel (the corrupt demo's ``--screen`` server refuses the
switch, as the reference's does, so that demo keeps the plain server phase).

  PYTHONPATH=src python -m repro_torch.examples.socket_federation --demo round --device cpu
  PYTHONPATH=src python -m repro_torch.examples.socket_federation --demo kill-resume --fused-server
  PYTHONPATH=src python -m repro_torch.examples.socket_federation --demo chaos --fused-server
  PYTHONPATH=src python -m repro_torch.examples.socket_federation --demo corrupt --device cpu

With ``--trace-dir DIR`` the chaos demo runs fully observed: every process
writes ``--trace`` JSONL there, the server serves live ``/metrics`` (probed),
and the merged trace must pass ``python -m repro_torch.obs.report DIR --check
--expect-faults``: all spans closed or excused by a recorded kill, no orphan
dispatch ids, the injected faults present in the audit.
"""
import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from repro_torch import resolve_device

KILL_EXIT_CODE = 137  # chaos kill / SIGKILL — supervisors respawn on it
#: the directory that holds the ``repro_torch`` package
SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _base_cmd(args):
    return [
        sys.executable, "-m", "repro_torch.launch.train",
        "--reduced", "--local-steps", "4", "--clients", "2",
        "--population", "4", "--seq-len", "64", "--batch", "2",
        "--aggregation", "async", "--buffer-size", "2",
        "--straggler-profile", "heavy", "--uplink", "topk",
        "--topk-fraction", "0.1", "--seed", str(args.seed),
        "--eval-batches", "1", "--device", args.device,
    ] + (["--fused-server"] if args.fused_server else [])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get(
        "PYTHONPATH", ""
    )
    env["PYTHONUNBUFFERED"] = "1"
    return env


def _spawn(cmd, logpath):
    log = open(logpath, "ab")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=_env())


def _wait_for_port(logpath, proc, timeout=120.0):
    """The server prints 'server listening on host:port' at startup."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(logpath):
            m = re.search(
                rb"server listening on [\d.]+:(\d+)", open(logpath, "rb").read()
            )
            if m:
                return int(m.group(1))
        if proc.poll() is not None:
            sys.exit(f"server died before listening:\n{open(logpath).read()}")
        time.sleep(0.2)
    sys.exit("server never started listening")


def _start_server(args, rounds, ckpt, logpath, resume=False, port=0, extra=None):
    cmd = _base_cmd(args) + [
        "--rounds", str(rounds), "--runtime", "sockets", "--role", "server",
        "--port", str(port), "--ckpt-dir", ckpt,
        "--lease-timeout", "15", "--io-timeout", "30",
    ] + (extra or [])
    if args.trace_dir:
        cmd += ["--trace", os.path.join(args.trace_dir, "server.jsonl"),
                "--metrics-port", "0"]
    if resume:
        cmd.append("--resume")
    proc = _spawn(cmd, logpath)
    return proc, _wait_for_port(logpath, proc)


def _worker_cmd(args, rounds, port, wid, chaos=None):
    cmd = _base_cmd(args) + [
        "--rounds", str(rounds), "--runtime", "sockets", "--role", "client",
        "--port", str(port), "--worker-id", wid, "--io-timeout", "30",
    ]
    if args.trace_dir:
        # respawned incarnations append to the same file; events are keyed by
        # (proc, pid) so the report tells the incarnations apart
        cmd += ["--trace", os.path.join(args.trace_dir, f"{wid}.jsonl")]
    if chaos:
        cmd += [
            "--chaos-drop", str(chaos.get("drop", 0)),
            "--chaos-delay", str(chaos.get("delay", 0)),
            "--chaos-kill", str(chaos.get("kill", 0)),
            "--chaos-seed", str(chaos.get("seed", 0)),
        ]
        if chaos.get("corrupt"):
            cmd += [
                "--chaos-corrupt", str(chaos["corrupt"]),
                "--chaos-corrupt-kinds", chaos.get("corrupt_kinds", "nan,inf"),
            ]
    return cmd


def _supervise_workers(workers, server, logdir, respawn=True):
    """Babysit worker processes until the server exits; respawn any worker that
    dies while the run is still going (chaos kill exits with 137)."""
    respawns = 0
    while server.poll() is None:
        for i, (proc, cmd) in enumerate(workers):
            rc = proc.poll()
            if rc is not None and respawn and server.poll() is None:
                respawns += 1
                print(f"[supervisor] worker {i} exited rc={rc}; respawning "
                      f"(#{respawns})")
                workers[i] = (
                    _spawn(cmd, os.path.join(logdir, f"worker{i}.log")), cmd
                )
        time.sleep(0.3)
    for proc, _ in workers:  # server done: workers drain the "done" answer
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
    return respawns


def _run_inproc(args, rounds, ckpt):
    cmd = _base_cmd(args) + ["--rounds", str(rounds), "--ckpt-dir", ckpt]
    subprocess.run(cmd, check=True, env=_env(), stdout=subprocess.DEVNULL)


def _assert_same_npz(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert set(a.files) == set(b.files), set(a.files) ^ set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    print(f"PASS: {len(a.files)} arrays bitwise-equal "
          f"({os.path.basename(os.path.dirname(a_path))})")


def _round_dir(ckpt, rnd):
    return os.path.join(ckpt, f"round_{rnd:06d}")


def _round_complete(ckpt, rnd):
    d = _round_dir(ckpt, rnd)
    try:
        json.load(open(os.path.join(d, "manifest.json")))
        return os.path.exists(os.path.join(d, "server.npz"))
    except (OSError, json.JSONDecodeError):
        return False


def demo_round(args, tmp):
    rounds, ckpt = 2, os.path.join(tmp, "sock_ck")
    server, port = _start_server(
        args, rounds, ckpt, os.path.join(tmp, "server.log")
    )
    workers = []
    for i in range(2):
        cmd = _worker_cmd(args, rounds, port, f"w{i}")
        workers.append((_spawn(cmd, os.path.join(tmp, f"worker{i}.log")), cmd))
    _supervise_workers(workers, server, tmp, respawn=False)
    assert server.returncode == 0, open(os.path.join(tmp, "server.log")).read()
    ref = os.path.join(tmp, "inproc_ck")
    _run_inproc(args, rounds, ref)
    _assert_same_npz(
        os.path.join(_round_dir(ckpt, rounds - 1), "server.npz"),
        os.path.join(_round_dir(ref, rounds - 1), "server.npz"),
    )


def demo_kill_resume(args, tmp):
    rounds, ckpt = 3, os.path.join(tmp, "sock_ck")
    server, port = _start_server(
        args, rounds, ckpt, os.path.join(tmp, "server.log")
    )
    workers = []
    for i in range(2):
        cmd = _worker_cmd(args, rounds, port, f"w{i}")
        workers.append((_spawn(cmd, os.path.join(tmp, f"worker{i}.log")), cmd))
    # SIGKILL the server the moment its first checkpoint is complete: no
    # shutdown hooks run, the socket vanishes under the workers mid-protocol
    while not _round_complete(ckpt, 0):
        assert server.poll() is None, "server died before its first checkpoint"
        time.sleep(0.2)
    server.send_signal(signal.SIGKILL)
    server.wait()
    print(f"[supervisor] server SIGKILLed after round 0 (rc={server.returncode})")
    # workers are now retrying against a dead port under backoff; a fresh
    # server process resumes from the checkpoint on a NEW port — rebind the
    # workers by respawning them (their backoff would otherwise spin on the
    # old port until give-up)
    for proc, _ in workers:
        proc.kill()
    server2, port2 = _start_server(
        args, rounds, ckpt, os.path.join(tmp, "server2.log"), resume=True
    )
    workers = []
    for i in range(2):
        cmd = _worker_cmd(args, rounds, port2, f"w{i}")
        workers.append((_spawn(cmd, os.path.join(tmp, f"worker{i}.log")), cmd))
    _supervise_workers(workers, server2, tmp, respawn=False)
    assert server2.returncode == 0, open(os.path.join(tmp, "server2.log")).read()
    ref = os.path.join(tmp, "inproc_ck")
    _run_inproc(args, rounds, ref)
    _assert_same_npz(
        os.path.join(_round_dir(ckpt, rounds - 1), "server.npz"),
        os.path.join(_round_dir(ref, rounds - 1), "server.npz"),
    )


def _probe_metrics(server, logpath, timeout=60.0):
    """GET the server's live /metrics endpoint once it announces its port."""
    import urllib.request

    deadline = time.time() + timeout
    while time.time() < deadline and server.poll() is None:
        m = re.search(
            rb"metrics serving on [\d.]+:(\d+)", open(logpath, "rb").read()
        )
        if m:
            url = f"http://127.0.0.1:{int(m.group(1))}/metrics"
            try:
                body = urllib.request.urlopen(url, timeout=5).read().decode()
            except OSError:
                time.sleep(0.5)
                continue
            assert "fed_" in body, f"metrics endpoint served no fed_ series:\n{body}"
            print(f"PASS: live metrics endpoint "
                  f"({sum(1 for l in body.splitlines() if l and l[0] != '#')} series)")
            return
        time.sleep(0.2)
    sys.exit("metrics endpoint never came up")


def _check_trace(args, expect_faults):
    """Validate the merged trace with the report CLI: every span accounted
    for, no orphan dispatch ids, injected faults present in the audit."""
    cmd = [sys.executable, "-m", "repro_torch.obs.report", args.trace_dir, "--check",
           "--chrome", os.path.join(args.trace_dir, "trace.json")]
    if expect_faults:
        cmd.append("--expect-faults")
    subprocess.run(cmd, check=True, env=_env())
    print(f"PASS: trace check ({args.trace_dir})")


def demo_chaos(args, tmp):
    rounds, ckpt = 2, os.path.join(tmp, "sock_ck")
    server, port = _start_server(
        args, rounds, ckpt, os.path.join(tmp, "server.log")
    )
    workers = []
    for i in range(2):
        cmd = _worker_cmd(
            args, rounds, port, f"w{i}",
            chaos={"drop": 0.10, "delay": 0.15, "kill": 0.04, "seed": 7 + i},
        )
        workers.append((_spawn(cmd, os.path.join(tmp, f"worker{i}.log")), cmd))
    if args.trace_dir:
        _probe_metrics(server, os.path.join(tmp, "server.log"))
    respawns = _supervise_workers(workers, server, tmp, respawn=True)
    assert server.returncode == 0, open(os.path.join(tmp, "server.log")).read()
    assert _round_complete(ckpt, rounds - 1), "chaos run never finished"
    log = open(os.path.join(tmp, "server.log")).read()
    losses = [float(m) for m in re.findall(r"loss=([\d.]+)", log)]
    assert losses and all(np.isfinite(losses)), "non-finite loss under chaos"
    print(f"PASS: chaos run converged (final loss {losses[-1]:.4f}, "
          f"{respawns} worker respawns absorbed)")
    if args.trace_dir:
        _check_trace(args, expect_faults=True)


def demo_corrupt(args, tmp):
    """Payload-level Byzantine chaos against the defended server: one worker
    corrupts most of its pushes (NaN/Inf deltas — the frames themselves stay
    CRC-valid, so only the server's delta screen stands between the poison and
    the model), the other stays honest. The screened door must reject every
    poisoned push, the run must converge on the honest ones, and the merged
    trace must carry ``screen_reject`` instants covering each ``corrupt_*``
    fault (``report --check --expect-faults`` audits exactly that)."""
    if not args.trace_dir:  # the audit IS the demo — always trace
        args.trace_dir = os.path.join(tmp, "trace")
        os.makedirs(args.trace_dir, exist_ok=True)
    rounds, ckpt = 2, os.path.join(tmp, "sock_ck")
    # the screened door is a robust server phase, which the fused one is not:
    # the server keeps the plain phase, the workers their --fused-server encode
    server_args = argparse.Namespace(**{**vars(args), "fused_server": False})
    server, port = _start_server(
        server_args, rounds, ckpt, os.path.join(tmp, "server.log"),
        extra=["--screen", "--screen-warmup", "2", "--quarantine-rounds", "1"],
    )
    workers = []
    for i in range(2):
        cmd = _worker_cmd(
            args, rounds, port, f"w{i}",
            chaos={"corrupt": 0.9 if i == 0 else 0.0,
                   "corrupt_kinds": "nan,inf", "seed": 11 + i},
        )
        workers.append((_spawn(cmd, os.path.join(tmp, f"worker{i}.log")), cmd))
    _supervise_workers(workers, server, tmp, respawn=True)
    assert server.returncode == 0, open(os.path.join(tmp, "server.log")).read()
    assert _round_complete(ckpt, rounds - 1), "corrupted run never finished"
    log = open(os.path.join(tmp, "server.log")).read()
    losses = [float(m) for m in re.findall(r"loss=([\d.]+)", log)]
    assert losses and all(np.isfinite(losses)), "non-finite loss under corruption"

    merged = "".join(
        open(os.path.join(args.trace_dir, f)).read()
        for f in os.listdir(args.trace_dir) if f.endswith(".jsonl")
    )
    n_corrupt = merged.count('"corrupt_')
    n_screen = merged.count('"screen_reject"')
    assert n_corrupt > 0, "chaos never corrupted a payload (dice too kind?)"
    assert n_screen > 0, "delta screen never fired on a poisoned push"
    print(f"PASS: corrupt run converged (final loss {losses[-1]:.4f}, "
          f"{n_corrupt} corruptions injected, {n_screen} screen rejections)")
    _check_trace(args, expect_faults=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo", default="round",
                    choices=["round", "kill-resume", "chaos", "corrupt"])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--trace-dir", default=None,
                    help="write per-process --trace JSONL here, probe the "
                         "live /metrics endpoint, and validate the merged "
                         "trace with repro_torch.obs.report (chaos demo)")
    ap.add_argument("--keep-tmp", action="store_true")
    ap.add_argument("--fused-server", action="store_true",
                    help="every process takes the train CLI's --fused-server: the "
                         "CUDA server_apply and topk_mask_ef kernels on the card")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card for a cuda run: fail here, not in each process
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"socket_fed_{args.demo.replace('-', '_')}_")
    print(f"workdir: {tmp}")
    {"round": demo_round, "kill-resume": demo_kill_resume,
     "chaos": demo_chaos, "corrupt": demo_corrupt}[args.demo](args, tmp)
    if not args.keep_tmp:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
