"""Model configurations, copied from the reference package: ``base`` and the
six archs the port runs (four dense ``attn``+``mlp`` ones, Mamba-2 and
RecurrentGemma); ``registry`` lists only those."""
