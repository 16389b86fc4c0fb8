"""Step factories: ``make_train_step``, ``make_prefill_step`` and ``make_serve_step``."""
