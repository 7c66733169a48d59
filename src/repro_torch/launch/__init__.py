"""Launchers of the port: :mod:`serve` (the LM token engine and its
CLI). Importing this package imports no launcher: run one with
``python -m repro_torch.launch.<name>``. The JAX package's mesh, train
and dry-run launchers wait for a later slice of the port."""
