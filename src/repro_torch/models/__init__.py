"""The dense language model: ``common`` (norms, rope, init), ``attention``
(K3 under the forward, K4 under the decode step), ``mlp``, ``transformer``."""
