"""Serving example on the PyTorch / CUDA port: batched autoregressive
generation + the paper's sketch-retrieval plane (0-bit CWS of request
states -> bST lookup), returning the top-k nearest documents per request
with exact distances — ``examples/retrieval_serve.py`` on
``repro_torch.launch.serve``.

    PYTHONPATH=src python examples/retrieval_serve_torch.py [--device cuda|cpu]

On ``cuda`` the prefill attention runs the flash kernel and the
retrieval plane the verify, scan and re-rank kernels; on ``cpu`` their
plain PyTorch versions.
"""

import argparse
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return serve_main(["--arch", "smollm-135m", "--smoke", "--batch", "4",
                       "--prompt-len", "24", "--gen-len", "12",
                       "--retrieval", "--index-size", "2048", "--tau", "3",
                       "--topk", "3", "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
