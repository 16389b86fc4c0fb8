"""Entry points: ``serve`` (continuous-batching ``Engine``) and ``train``
(the training driver with checkpoints and restarts); ``mesh`` builds the
device meshes they run on."""
