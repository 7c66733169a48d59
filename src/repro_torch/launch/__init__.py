"""Launchers of the port: :mod:`serve` (the LM token engine and its
CLI, for each of the ten archs of :mod:`repro_torch.configs`). Importing
this package imports no launcher: run one with ``python -m
repro_torch.launch.<name>``. The JAX package's mesh, train and dry-run
launchers are not ported yet."""
