"""Launchers of the port: :mod:`serve` (the LM token engine and its
CLI), :mod:`train` (the training loop and its CLI: mesh planning,
checkpoints, the straggler watchdog, crash-restart), for each of the ten
archs of :mod:`repro_torch.configs`, and :mod:`dryrun` (the planner:
per-device memory, roofline terms and bottleneck of every (arch x shape
x production mesh) cell on H100 constants, counted on fake tensors) with
:mod:`mesh` (the production meshes). Importing this package imports no
launcher: run one with ``python -m repro_torch.launch.<name>``."""
