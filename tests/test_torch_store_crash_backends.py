"""Crash-at-point recovery of the port's durable store, part 3: the
multi backend and the sharded stacks, at the JAX package's sample of
their crash points (every 5th and every 7th, and the last; the harness
is ``tests/_torch_crash.py``)."""

import pytest

from _torch_crash import crash_recover_verify, n_points


@pytest.mark.parametrize(
    "point", sorted(set(range(0, n_points("multi"), 5))
                    | {n_points("multi") - 1}))
def test_crash_at_point_multi(tmp_path, point, monkeypatch):
    crash_recover_verify(tmp_path, "multi", point, monkeypatch)


@pytest.mark.parametrize(
    "point", sorted(set(range(0, n_points("stacks"), 7))
                    | {n_points("stacks") - 1}))
def test_crash_at_point_sharded_stacks(tmp_path, point, monkeypatch):
    crash_recover_verify(tmp_path, "stacks", point, monkeypatch)
