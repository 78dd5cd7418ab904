"""Serve a small model with batched requests on the port: prefill, then a
greedy decode loop (the twin of ``examples/serve_batched.py``).

    PYTHONPATH=src python examples/torch/serve_batched.py [--arch zamba2-2.7b] [--gen N] [--device cpu]

Runs ``repro_torch.launch.serve``'s entry point at the smoke config of
``--arch``: 4 requests of 32 prompt tokens and ``--gen`` (16) generated
ones, through the same ``serve_step`` the decode_32k / long_500k dry-run
cells walk (the SSM / hybrid recurrent-state path included), with the
request telemetry behind ``EnginePool`` and the request-shape search of
``ClusterEngine``. On the CUDA card unless ``--device cpu``.
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens generated per request (fewer: shorter)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    return serve_main(["--arch", args.arch, "--smoke", "--batch", "4",
                       "--prompt-len", "32", "--gen", str(args.gen)] + extra)


if __name__ == "__main__":
    main()
