"""The optimizer: ``adamw`` (AdamW, cosine schedule, global-norm clipping)."""
