"""The port's training driver, ``python -m repro_torch.launch.train``, on
the CPU: a dedup-fed SMOKE run, the restart drill (``--fail-at`` exits
13 after the async checkpoints land) and a rerun on the same
``--ckpt-dir`` that resumes and ends on the same bits as an
uninterrupted run — losses, parameters and optimiser state."""

import os

import numpy as np
import pytest
import torch

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels import ops
from repro_torch.launch import train

ARGS = ["--smoke", "--device", "cpu", "--dedup", "--steps", "6",
        "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--log-every",
        "1"]


def _run(argv):
    losses = {}

    def on_step(step, metrics):
        losses[step] = float(metrics["loss"])

    return train.main(argv, on_step=on_step), losses


def test_dedup_train_drill_and_bitwise_resume(tmp_path, capsys):
    full_dir, drill_dir = str(tmp_path / "full"), str(tmp_path / "drill")
    ops.reset_kernel_stats()
    rc, full = _run(ARGS + ["--ckpt-dir", full_dir])
    assert rc == 0 and sorted(full) == list(range(6))
    stats = ops.kernel_stats()
    # 2 attention layers: 2 forwards (one more under remat) and 1 backward
    # each, every step; the history search from step 1 on
    assert stats["flash_attention_fwd:ref"] == 6 * 2 * 2
    assert stats["flash_attention_bwd:ref"] == 6 * 2
    assert stats["sparse_verify_batch:ref"] == 5
    out = capsys.readouterr().out
    assert "step     1  loss " in out and "train: done" in out
    assert ckpt.list_checkpoints(full_dir) == [2, 4, 6]

    rc, first = _run(ARGS + ["--ckpt-dir", drill_dir, "--fail-at", "4"])
    assert rc == 13 and sorted(first) == [0, 1, 2, 3]
    assert "[drill] injected node failure at step 4" in capsys.readouterr().out
    assert ckpt.latest_checkpoint(drill_dir) == 4

    rc, resumed = _run(ARGS + ["--ckpt-dir", drill_dir])
    assert rc == 0 and sorted(resumed) == [4, 5]
    assert "[resume] from step 4" in capsys.readouterr().out
    for step in (0, 1, 2, 3):
        assert first[step] == full[step]
    for step in (4, 5):
        assert resumed[step] == full[step]
    a = np.load(os.path.join(full_dir, "step_0000006", "arrays.npz"))
    b = np.load(os.path.join(drill_dir, "step_0000006", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert "opt/step" in a.files and "params/units/l0/wq" in a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_microbatched_hubert_smoke_runs():
    """The frontend-stub branch (embeds batches) with 2 microbatches."""
    rc, losses = _run(["--arch", "hubert-xlarge", "--smoke", "--device",
                       "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
                       "--microbatches", "2"])
    assert rc == 0 and sorted(losses) == [0, 1]
    assert all(np.isfinite(v) for v in losses.values())


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])
