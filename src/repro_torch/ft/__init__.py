"""Fault tolerance: ``runtime`` (step monitor, failure injection, the
checkpoint-restart driver)."""
