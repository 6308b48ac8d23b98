"""The training driver, ``launch.train.main``, for the MoE, SSM, hybrid
and encoder families on the CPU (SMOKE configs), as ``chip_smoke.py``
phase 17 runs them at full width on the card: two steps of each family
in the microbatches the card's run takes, finite losses and gradient
norms, the flash forwards and backwards every attention layer of a
microbatch runs (two forwards under remat, one backward; the plain
versions here); ``--device-init`` draws the weights the default draws
on the CPU, whose generator both are there.  Then the restart drill for
the SSM and the MoE
(``--fail-at`` exits 13 once the checkpoint of step 1 has landed, the
rerun resumes from it) against an uninterrupted run: losses, parameters
and optimiser state bit for bit."""

import os

import numpy as np
import pytest

from repro_torch.configs.registry import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import model as M

# each family in the microbatches of the card's run at 8 x 2,048
FAMILIES = {"mamba2-1.3b": 2, "hubert-xlarge": 2, "granite-moe-3b-a800m": 1,
            "zamba2-2.7b": 4}
SMALL = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16",
         "--log-every", "1"]


def _run(argv):
    got = {}

    def on_step(step, metrics):
        got[step] = (float(metrics["loss"]), float(metrics["grad_norm"]))

    return train.main(argv, on_step=on_step), got


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_trains_through_the_driver(arch, capsys):
    mb = FAMILIES[arch]
    argv = ["--arch", arch, "--steps", "2", "--microbatches", str(mb),
            *SMALL]
    ops.reset_kernel_stats()
    rc, got = _run(argv)
    assert rc == 0 and sorted(got) == [0, 1]
    assert all(np.isfinite(v).all() for v in got.values()), got
    n_attn = M.n_attention_layers(get_config(arch, smoke=True))
    assert ops.kernel_stats() == (
        {"flash_attention_fwd:ref": 2 * 2 * n_attn * mb,
         "flash_attention_bwd:ref": 2 * n_attn * mb} if n_attn else {})
    out = capsys.readouterr().out
    assert "step     2  loss " in out and "train: done" in out
    rc, drawn = _run(argv + ["--device-init"])
    assert rc == 0 and drawn == got


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "granite-moe-3b-a800m"])
def test_family_drill_resumes_bit_for_bit(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--steps", "3", "--ckpt-every", "1",
            "--microbatches", str(FAMILIES[arch]), *SMALL]
    full_dir, drill_dir = str(tmp_path / "full"), str(tmp_path / "drill")
    rc, full = _run(argv + ["--ckpt-dir", full_dir])
    assert rc == 0 and sorted(full) == [0, 1, 2]
    assert ckpt.list_checkpoints(full_dir) == [1, 2, 3]
    rc, first = _run(argv + ["--ckpt-dir", drill_dir, "--fail-at", "1"])
    assert rc == 13 and first == {0: full[0]}
    assert ckpt.latest_checkpoint(drill_dir) == 1
    capsys.readouterr()
    rc, resumed = _run(argv + ["--ckpt-dir", drill_dir])
    assert rc == 0 and resumed == {1: full[1], 2: full[2]}
    assert "[resume] from step 1" in capsys.readouterr().out
    a = np.load(os.path.join(full_dir, "step_0000003", "arrays.npz"))
    b = np.load(os.path.join(drill_dir, "step_0000003", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files) and "opt/step" in a.files
    leaf = ("params/units/l0/ssm/wx" if arch.startswith("mamba2")
            else "params/units/l0/moe/w_gate")
    assert leaf in a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
