"""End-to-end training driver on the port: a reduced LM trained with the
paper's technique in three places — importance-sampled data, sampled
telemetry, and (on a multi-pod mesh) the sampled gradient exchange (the
twin of ``examples/train_with_sampled_telemetry.py``).

    PYTHONPATH=src python examples/torch/train_with_sampled_telemetry.py \\
        [--arch granite-moe-1b-a400m] [--steps 300] [--device cpu]

Runs ``repro_torch.launch.train``'s entry point at the smoke config of
``--arch``: batch 8 x 128, importance sampling on, a checkpoint every 100
steps (into a temporary directory, removed at the end), a log line every
20. On the CUDA card unless ``--device cpu``.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--steps", type=int, default=300,
                    help="train steps (fewer: shorter)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt:
        return train_main([
            "--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "128",
            "--importance-sampling",
            "--ckpt-dir", ckpt,
            "--ckpt-every", "100",
            "--log-every", "20",
        ] + extra)


if __name__ == "__main__":
    main()
