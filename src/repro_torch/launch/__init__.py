"""Entry points: ``serve`` (batched greedy generation)."""
