"""The port's tools and examples on the CPU: ``tools/*_torch.py`` and
``examples/*_torch.py`` held against their JAX counterparts.

  * ``eval_recall_torch``: ``tests/test_recall_eval.py``'s five checks,
    and its ``--smoke`` report equal to the JAX tool's, number for
    number (recall, τ*: the same corpus, sketches and ground truth, and
    an index that is bit-identical to the JAX package's);
  * ``capacity_smoke_torch`` and ``recovery_smoke_torch`` at small
    sizes: exit 0, the capacity tool's column bytes the JAX tool's;
  * ``overload_smoke_torch``'s expired, degrade and breaker scenarios
    under their own gates (the burst's gates are timing gates, run on
    the card by ``chip_smoke.py``);
  * both examples with ``--device cpu``.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


ev = _load(ROOT / "tools" / "eval_recall_torch.py", "eval_recall_torch")
cap = _load(ROOT / "tools" / "capacity_smoke_torch.py",
            "capacity_smoke_torch")
rec = _load(ROOT / "tools" / "recovery_smoke_torch.py",
            "recovery_smoke_torch")
ovl = _load(ROOT / "tools" / "overload_smoke_torch.py",
            "overload_smoke_torch")

SMOKE = dict(n_docs=600, n_queries=20, L=32, delta_cap=256, k=10)
_REPORT = None


def report():
    global _REPORT
    if _REPORT is None:
        _REPORT = ev.evaluate(device="cpu", **SMOKE)
    return _REPORT


# -- eval_recall_torch: tests/test_recall_eval.py on the port ---------------

def test_reranked_recall_dominates_sketch_only_and_floor():
    rows = report()["rows"]
    assert [r["b"] for r in rows] == [1, 2, 4]
    for row in rows:
        assert row["reranked"] >= row["sketch"], row
        assert row["reranked"] >= ev.RECALL_FLOOR, row


def test_ground_truth_is_exact_jaccard_order():
    rng = np.random.default_rng(0)
    docs = ev.build_corpus(rng, 50, 64)
    qs = [ev.perturb(rng, docs[3], 64)]
    from repro_torch.core.hamming import pack_sets
    dp, qp = pack_sets(docs, 64), pack_sets(qs, 64)
    top = ev.exact_jaccard_topk(qp, dp, 5)[0]
    jac = []
    for d in docs:
        a, b = set(map(int, qs[0])), set(map(int, d))
        jac.append(len(a & b) / len(a | b))
    want = sorted(range(50), key=lambda i: (-jac[i], i))[:5]
    assert list(map(int, top)) == want


def test_minhash_sketch_collision_rate_tracks_jaccard():
    rng = np.random.default_rng(1)
    base = ev.build_corpus(rng, 1, 128, set_min=20, set_max=30)[0]
    near = ev.perturb(rng, base, 128, frac=0.1)
    far = ev.build_corpus(rng, 1, 128, set_min=20, set_max=30)[0]
    sk = ev.minhash_sketch([base, near, far], 64, 2, 128)
    assert int((sk[0] == sk[1]).sum()) > int((sk[0] == sk[2]).sum())


def test_recall_at_k_counts_pads_as_misses():
    truth = np.array([[1, 2, 3, 4]])
    assert ev.recall_at_k(np.array([[1, 2, -1, -1]]), truth) == 0.5


def test_cli_smoke_check_passes(tmp_path, capsys):
    out = tmp_path / "recall.json"
    rc = ev.main(["--smoke", "--check", "--out", str(out), "--device",
                  "cpu"])
    assert rc == 0
    assert out.exists()
    assert "recall gate passed" in capsys.readouterr().out


def test_smoke_report_equals_the_jax_tools():
    jev = _load(ROOT / "tools" / "eval_recall.py", "eval_recall")
    assert report() == jev.evaluate(**SMOKE)
    # the corpus helpers are copies
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    docs = ev.build_corpus(rng_a, 20, 64)
    assert all(np.array_equal(a, b)
               for a, b in zip(docs, jev.build_corpus(rng_b, 20, 64)))
    assert np.array_equal(ev.perturb(rng_a, docs[0], 64),
                          jev.perturb(rng_b, docs[0], 64))
    assert np.array_equal(ev.minhash_sketch(docs, 16, 2, 64),
                          jev.minhash_sketch(docs, 16, 2, 64))


# -- capacity and recovery ----------------------------------------------------

def test_capacity_smoke_runs_with_the_jax_tools_column_bytes(capsys):
    assert cap.main(["512", "--device", "cpu"]) == 0
    assert "capacity smoke OK" in capsys.readouterr().out
    jcap = _load(ROOT / "tools" / "capacity_smoke.py", "capacity_smoke")
    for layout, refresh in (("suffix", "_refresh_store"),
                            ("full", "_refresh_arena")):
        mine, _ = cap.build(512, "cpu", layout=layout)
        theirs, _ = jcap.build(512, layout=layout)
        assert (getattr(mine, refresh)().col_bytes()
                == getattr(theirs, refresh)().col_bytes())


def test_recovery_smoke_runs(capsys):
    assert rec.main(["256", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "recovery smoke OK" in out
    assert "docs: n_live=" in out and "stacks: n_live=" in out


# -- overload: the scenarios whose gates are not timings ----------------------

def test_overload_expired_never_dispatch():
    res = ovl.run_expired_never_dispatch(device="cpu")
    ovl.check_expired(res)
    assert res["cancelled"] == 16


def test_overload_degrade_identity():
    res = ovl.run_degrade_identity(device="cpu")
    ovl.check_degrade(res)
    assert res["topk_stage"] == "shrink_k"
    assert res["search_stage"] == "cheap_tau"


def test_overload_breaker_lifecycle():
    ovl.check_breaker(ovl.run_breaker_lifecycle(device="cpu"))


# -- the examples -------------------------------------------------------------

def test_retrieval_serve_example_runs_on_cpu(capsys):
    ex = _load(ROOT / "examples" / "retrieval_serve_torch.py",
               "retrieval_serve_torch")
    assert ex.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests x 12 tokens on cpu" in out
    assert "top-3 docs" in out


def test_train_smollm_example_runs_on_cpu(capsys, tmp_path):
    ex = _load(ROOT / "examples" / "train_smollm_torch.py",
               "train_smollm_torch")
    assert ex.main(["--smoke", "--steps", "4", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)]) == 0
    assert "train: done" in capsys.readouterr().out
