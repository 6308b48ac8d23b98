"""The port's serve CLI (``python -m repro_torch.launch.serve``)
against the JAX package's, on the CPU.

``--ingest`` (streaming inserts, deletes and top-k through the
scheduler, with the exact Jaccard re-rank), ``--ingest --recover`` (the
durable data directory rebuilt and served) and ``--retrieval --smoke``
(generation, then the requests' CWS sketches through the scheduler) run
with ``--device cpu`` and print the same answer lines as the JAX
package's CLI on the same flags: ``--retrieval`` with the JAX
package's weights (``params_from_jax``) and CWS draws carried across as
numpy.  A directory written by either CLI is recovered by the other.
Without ``--device cpu`` and without a card, ``main`` raises.
Tolerance: the printed ids, distances, τ* and (3-decimal) scores equal.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.launch import serve
from repro_torch.models.model import params_from_jax

INGEST = ["--ingest", "--index-size", "384", "--delta-cap", "64",
          "--batch", "6"]
# the lines that carry answers (times and per-package build counts
# excluded)
_ANSWER = re.compile(r"^(  request \d|mid-stream|deleted|retrieval:|"
                     r"recovered)")


def answers(text):
    out = []
    for line in text.splitlines():
        if _ANSWER.match(line):
            # the port names the device and directory it recovered on
            line = re.sub(r" on cpu:", ":", line)
            out.append(line)
    return out


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_ingest_matches_jax(capsys):
    """In memory (the durable mode is the next test's)."""
    argv = INGEST + ["--rerank", "jaccard", "--warmup"]
    port = run(serve.main, argv + ["--device", "cpu"], capsys)
    jax_ = run(jserve.main, argv, capsys)
    assert len(answers(port)) == 2 + 4 and answers(port) == answers(jax_)
    assert "jaccard scores" in port
    assert 'serving_requests_total{op="insert"}' in port


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_ingest_recover_across_packages(tmp_path, capsys, writer):
    """One CLI ingests into --data-dir; both CLIs --recover it and
    print the same recovered counts and answers."""
    d = str(tmp_path / "d")
    if writer == "torch":
        run(serve.main, INGEST + ["--device", "cpu", "--data-dir", d],
            capsys)
    else:
        run(jserve.main, INGEST + ["--data-dir", d], capsys)
    port = run(serve.main, INGEST + ["--recover", "--device", "cpu",
                                     "--data-dir", d], capsys)
    jax_ = run(jserve.main, INGEST + ["--recover", "--data-dir", d], capsys)
    got = answers(port)
    assert got[0].startswith("recovered 'docs'") and len(got) == 5
    assert got == answers(jax_)
    assert 'store_recovered_segments{collection="docs"}' in port
    assert "store_wal_bytes" in port


def test_retrieval_smoke_matches_jax(monkeypatch, capsys):
    """``--retrieval --smoke``: the JAX CLI's run, then the port's with
    the JAX package's weights and CWS draws — the same hits and top-k
    lines."""
    argv = ["--retrieval", "--smoke", "--index-size", "256"]
    jax_ = run(jserve.main, argv, capsys)

    jcfg = jget_config("smollm-135m", smoke=True)
    jparams = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    kr, kc, kb = jax.random.split(jax.random.PRNGKey(7), 3)
    draws = (jax.random.exponential(kr, (2, 32, 64)).sum(0),
             jax.random.exponential(kc, (2, 32, 64)).sum(0),
             jax.random.uniform(kb, (32, 64), dtype=jnp.float32))
    draws = tuple(torch.from_numpy(np.array(x, np.float32)) for x in draws)
    monkeypatch.setattr(
        serve.M, "init_params",
        lambda gen, cfg, device: params_from_jax(jparams, cfg,
                                                 device=device))
    monkeypatch.setattr(serve, "cws_params", lambda L, dim, gen: draws)
    port = run(serve.main, argv + ["--device", "cpu"], capsys)
    got = answers(port)
    assert len(got) == 5 and got[0].startswith("retrieval: tau=3")
    assert got == answers(jax_)
    # the continuation tokens agree too (f32 on both sides)
    tok = [ln for ln in port.splitlines() if ln.startswith("sample")]
    assert tok == [ln for ln in jax_.splitlines() if ln.startswith("sample")]


def test_retrieval_runs_on_its_own_draws(capsys):
    out = run(serve.main, ["--retrieval", "--smoke", "--index-size", "128",
                           "--device", "cpu"], capsys)
    got = answers(out)
    assert len(got) == 5 and "hits per request" in got[0]


def test_main_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--ingest"], ["--ingest", "--recover", "--data-dir",
                                str(tmp_path)],
                 ["--retrieval", "--smoke"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(argv)
