"""Entry points: ``serve`` (continuous-batching ``Engine``)."""
