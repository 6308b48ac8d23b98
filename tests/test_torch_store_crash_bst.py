"""Crash-at-every-point recovery of the port's durable store, part 2:
the second half of the bst backend's crash points (the harness is
``tests/_torch_crash.py``)."""

import pytest

from _torch_crash import crash_recover_verify, n_points

HALF = n_points("bst") // 2


@pytest.mark.parametrize("point", range(HALF, n_points("bst")))
def test_crash_at_every_point_bst(tmp_path, point, monkeypatch):
    crash_recover_verify(tmp_path, "bst", point, monkeypatch)
