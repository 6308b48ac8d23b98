"""The serve and train entry points with ``--model-ranks 2`` under
``torch.distributed.run``: two gloo CPU ranks at mesh (1, 2), the dense
layers tensor parallel over "model", against one rank's run of the same
command.

``launch.serve`` serves from the whole parameters, which each rank cuts
to its slices: smollm-135m (SMOKE: its 3 heads whole, ffn and
vocabulary split) and granite-moe-3b-a800m (SMOKE: heads split, the
experts cut to the rank's half) print one rank's continuation ids.
``launch.train`` (smollm-135m, SMOKE) prints one rank's losses and
gradient norms at every step, to their printed resolution (4 and 3
decimals; float32 sums in another order move them by ~1e-6 relative).
"""

import re
import sys

import pytest

from _torch_ranks import run_cli as _launch

RUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", "2"]


def _continuation(out: str) -> str:
    lines = [ln for ln in out.splitlines()
             if ln.startswith("continuation ids:")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m"])
def test_serve_cli_at_two_model_ranks_prints_one_rank_s_tokens(arch):
    argv = ["-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
            "--device", "cpu", "--batch", "4", "--prompt-len", "9",
            "--gen-len", "5"]
    want = _continuation(_launch([sys.executable, *argv]))
    out = _launch([*RUN, *argv, "--model-ranks", "2"])
    assert _continuation(out) == want
    assert "process group: backend gloo, 2 ranks" in out
    assert re.search(r"served 4 requests x 5 tokens on cpu x 2 model ranks",
                     out)


def _steps(out: str) -> dict:
    got = {int(s): (float(loss), float(norm)) for s, loss, norm in
           re.findall(r"step\s+(\d+)\s+loss (\S+)\s+gnorm (\S+)", out)}
    assert got, out
    return got


def test_train_cli_at_two_model_ranks_prints_one_rank_s_losses():
    argv = ["-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "64", "--log-every",
            "1"]
    want = _steps(_launch([sys.executable, *argv]))
    out = _launch([*RUN, *argv, "--model-ranks", "2"])
    got = _steps(out)
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for step, (loss, norm) in want.items():
        assert got[step][0] == pytest.approx(loss, abs=1e-4), step
        assert got[step][1] == pytest.approx(norm, abs=1e-3), step
    assert "process group: backend gloo, 2 ranks" in out
    assert out.count("kernel launches over 3 steps") == 2
