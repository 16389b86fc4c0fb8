"""Model configurations, copied from the reference package: ``base`` and the
ten archs of the reference's registry, which the port runs all (``registry``
differs from the reference's only in its ``KeyError``)."""
