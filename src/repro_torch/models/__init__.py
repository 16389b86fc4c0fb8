"""The language models: ``common`` (norms, rope, init), ``attention`` (K3
under the forward, K4 under the decode step; full or sliding-window),
``mlp``, ``ssd`` (Mamba-2, K5 under the forward), ``rglru`` (RG-LRU, K6
under the forward), ``transformer``."""
