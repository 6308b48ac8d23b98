"""The port's input stand-ins (``repro_torch.models.io``) against the JAX
package's ``models/io.py``.

``input_specs``: for every registry config and every cell of ``SHAPES``,
the port's ``meta`` tensors have the shapes and dtypes of the JAX
package's ``ShapeDtypeStruct``s (a decode cache leaf per unit: the JAX
leaf without its ``n_units`` axis); nothing is allocated on either side.
``synthetic_batch``: bit-equal to the JAX package's in one process
(ROADMAP F10: both seed from the process-salted ``hash(arch_id)``).
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import env_with_src
from repro.configs.registry import get_config as jget_config
from repro.models import io as JIO
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import io as TIO
from repro_torch.models.config import SHAPES

_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
           torch.bfloat16: jax.numpy.bfloat16}


def _same(mine: torch.Tensor, theirs, stacked=False):
    assert mine.device.type == "meta"
    shape = tuple(theirs.shape)[1:] if stacked else tuple(theirs.shape)
    assert tuple(mine.shape) == shape
    assert np.dtype(_DTYPES[mine.dtype]) == np.dtype(theirs.dtype)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    mine = TIO.input_specs(get_config(arch), SHAPES[shape])
    theirs = JIO.input_specs(jget_config(arch), JSHAPES[shape])
    assert mine.keys() == theirs.keys()
    if "batch" in mine:
        assert mine["batch"].keys() == theirs["batch"].keys()
        for k in mine["batch"]:
            _same(mine["batch"][k], theirs["batch"][k])
        return
    _same(mine["tokens"], theirs["tokens"])
    _same(mine["cache_len"], theirs["cache_len"])
    want = jax.tree_util.tree_leaves(theirs["cache"])
    cache = mine["cache"]
    assert len(cache) == get_config(arch).n_units
    for unit in cache:
        leaves = [x for layer in unit.values() for x in layer]
        assert len(leaves) == len(want)
        for got, w in zip(leaves, want):
            _same(got, w, stacked=True)


@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge",
                                  "granite-moe-3b-a800m"])
def test_synthetic_batch_is_bit_equal_in_process(arch):
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    for step in (0, 3):
        for with_targets in (True, False):
            mine = TIO.synthetic_batch(cfg, 3, 9, step, with_targets,
                                       device="cpu")
            theirs = JIO.synthetic_batch(jcfg, 3, 9, step, with_targets)
            assert mine.keys() == theirs.keys()
            for k in mine:
                assert mine[k].dtype in (torch.int32, torch.float32)
                np.testing.assert_array_equal(mine[k].numpy(),
                                              np.asarray(theirs[k]))
    again = TIO.synthetic_batch(cfg, 3, 9, 0, device="cpu")
    other = TIO.synthetic_batch(cfg, 3, 9, 1, device="cpu")
    first = next(iter(again))
    assert not torch.equal(again[first], other[first])


def test_synthetic_batch_across_processes_needs_a_fixed_hash_seed():
    """F10: two interpreters draw the same batch only when they share
    ``PYTHONHASHSEED``."""
    code = ("from repro_torch.configs.registry import get_config\n"
            "from repro_torch.models.io import synthetic_batch\n"
            "b = synthetic_batch(get_config('smollm-135m', smoke=True), 2, 16,"
            " 0, device='cpu')\n"
            "print(b['tokens'].flatten().tolist())\n")

    def draw(seed):
        env = dict(env_with_src(), PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout

    assert draw("7") == draw("7") != draw("8")
