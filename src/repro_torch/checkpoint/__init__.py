"""Checkpoints: ``store`` (atomic save and restore, an asynchronous writer)."""
