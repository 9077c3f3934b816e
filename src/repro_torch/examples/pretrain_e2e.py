"""End-to-end driver, the port of ``examples/pretrain_e2e.py``: federated
pre-training with checkpointing, auto-resume, partial participation, DP
clipping and CSV metric logging through ``repro_torch.launch.train``, with the
reference example's arguments.

The demo is reduced photon-75m; ``--full`` is photon-125m at its published
widths (4 rounds x 100 local steps, 4 of 8 clients, B = 4, S = 512).
Checkpoints and metrics go to ``results/`` under the working directory, and
``--resume`` picks up a run found there (a finished one prints
``final: resumed-complete`` and trains nothing). ``--fused-server`` hands the
train CLI its switch of that name: the server step runs as the CUDA
``server_apply`` kernel on the card, once per round.

  PYTHONPATH=src python -m repro_torch.examples.pretrain_e2e --device cpu   # demo scale
  PYTHONPATH=src python -m repro_torch.examples.pretrain_e2e --full --fused-server
"""
import argparse

from repro_torch.launch.train import parse_args, run


def train_argv(args) -> list:
    """The train CLI's arguments: the reference example's, then ``--device``
    and, when asked, ``--fused-server``."""
    if args.full:
        argv = [
            "--arch", "photon-125m", "--rounds", "4", "--local-steps", "100",
            "--clients", "4", "--population", "8", "--batch", "4", "--seq-len", "512",
            "--heterogeneous", "--ckpt-dir", "results/e2e_ckpt", "--resume",
            "--log", "results/e2e_metrics.csv",
        ]
    else:
        argv = [
            "--arch", "photon-75m", "--reduced", "--rounds", "5", "--local-steps", "12",
            "--clients", "3", "--population", "6", "--batch", "2", "--seq-len", "128",
            "--heterogeneous", "--dp-clip", "10.0",
            "--ckpt-dir", "results/e2e_ckpt_demo", "--resume",
            "--log", "results/e2e_metrics_demo.csv",
        ]
    argv += ["--device", args.device]
    return argv + (["--fused-server"] if args.fused_server else [])


def example_args(argv=None):
    """The example's own flags; the rest of ``argv`` is ignored, as the
    reference example ignores it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="photon-125m (~124M params), a few hundred local steps")
    ap.add_argument("--fused-server", action="store_true",
                    help="the server step as the fused server_apply kernel (on the card)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_known_args(argv)[0]


def main(argv=None):
    """Runs the example; returns the train CLI's result (``run``'s dict)."""
    out = run(parse_args(train_argv(example_args(argv))))
    final = out["history"][-1] if out["history"] else {}
    print(f"final: {final.get('train_loss', 'resumed-complete')}")
    return out


if __name__ == "__main__":
    main()
