"""Launchers of the port: :mod:`serve` (the LM token engine and its
CLI) and :mod:`train` (the training loop and its CLI: mesh planning,
checkpoints, the straggler watchdog, crash-restart), for each of the ten
archs of :mod:`repro_torch.configs`. Importing this package imports no
launcher: run one with ``python -m repro_torch.launch.<name>``. The JAX
package's production-mesh and dry-run launchers are not ported yet."""
