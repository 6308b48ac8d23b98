"""Crash-at-every-point recovery of the port's durable store, part 1:
the crash points and their labels equal the JAX package's, and the first
half of the bst backend's points (``tests/_torch_crash.py`` holds the
harness; ``test_torch_store_crash_bst.py`` and
``test_torch_store_crash_backends.py`` the rest).  Each recovered index
is held bit for bit against the port's own never-crashed one.
"""

import pytest

from _torch_crash import crash_recover_verify, n_points, points

HALF = n_points("bst") // 2


@pytest.mark.parametrize("kind", ["bst", "multi", "stacks"])
def test_crash_points_match_jax(kind):
    """The port crosses the same fsync/rename boundaries, in the same
    order, as the JAX package on the same workload."""
    assert points(kind) == points(kind, "jax")


@pytest.mark.parametrize("point", range(HALF))
def test_crash_at_every_point_bst(tmp_path, point, monkeypatch):
    crash_recover_verify(tmp_path, "bst", point, monkeypatch)
