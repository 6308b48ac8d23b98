"""Optimisers: ``adamw`` (AdamW, cosine schedule, global-norm clip)."""
