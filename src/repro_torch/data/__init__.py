"""The training data plane: ``pipeline`` (sketch-dedup'd batches)."""
