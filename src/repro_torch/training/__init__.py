"""Training: optimizers on tensor trees, the ``Trainer``, checkpoints and
fault-tolerance policies — the JAX package's ``training/`` in PyTorch."""
