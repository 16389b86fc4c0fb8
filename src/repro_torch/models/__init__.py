"""The language models: ``common`` (norms, rope, init), ``attention`` (K3
under the forward, K4 under the decode step; full, sliding-window,
bidirectional or cross), ``mla`` (multi-head latent attention, K3 with
query/key and value head dims apart under the forward), ``mlp`` (gated MLP
and MoE), ``ssd`` (Mamba-2, K5 under the forward), ``rglru`` (RG-LRU, K6
under the forward), ``transformer`` (blocks, encoder, the LM)."""
