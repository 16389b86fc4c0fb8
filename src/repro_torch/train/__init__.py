"""Step factories: ``make_prefill_step`` and ``make_serve_step``."""
