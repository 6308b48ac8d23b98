"""End-to-end driver on the PyTorch / CUDA port: train a ~100M-class
model (smollm-135m family) on synthetic data with bST near-duplicate
filtering, checkpoint/restart, and loss-curve reporting —
``examples/train_smollm.py`` on ``repro_torch.launch.train``.

    PYTHONPATH=src python examples/train_smollm_torch.py          # full width
    PYTHONPATH=src python examples/train_smollm_torch.py --smoke  # reduced config

Checkpoints go to ``--ckpt-dir`` (a temporary directory, removed at the
end, when none is given).  On ``cuda`` attention runs the flash forward
and FA-2 backward kernels and the dedup filter the verify kernel; on
``cpu`` their plain PyTorch versions.
"""

import argparse
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    steps = args.steps or (60 if args.smoke else 300)
    with tempfile.TemporaryDirectory(prefix="smollm_ckpt_") as tmp:
        argv = ["--arch", "smollm-135m", "--steps", str(steps),
                "--batch", "8", "--seq", "128" if args.smoke else "512",
                "--dedup", "--ckpt-dir", args.ckpt_dir or tmp,
                "--ckpt-every", "50", "--log-every", "10",
                "--device", args.device]
        if args.smoke:
            argv.append("--smoke")
        return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
