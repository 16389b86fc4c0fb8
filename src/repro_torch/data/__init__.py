"""Data: ``pipeline`` (the deterministic, seekable synthetic token stream)."""
