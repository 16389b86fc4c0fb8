"""Model configurations, copied from the reference package: ``base`` and the
four dense ``attn``+``mlp`` archs the port runs; ``registry`` lists only those."""
