"""Analysis of the port: the H100's data-sheet constants (:mod:`hw`),
an op-level cost counter over a step run eagerly or on fake tensors
(:mod:`op_cost`, the counterpart of the JAX package's HLO walker), the
roofline terms and kernel cells built on them (:mod:`roofline`), and the
perf-trajectory ledger over the port's benchmark records
(:mod:`trajectory`: series, per-metric regression verdicts, the baseline
record, figures)."""
from . import trajectory  # noqa: F401
