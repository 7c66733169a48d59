"""Analysis of the port: the H100's data-sheet constants (:mod:`hw`),
an op-level cost counter over a step run eagerly or on fake tensors
(:mod:`op_cost`, the counterpart of the JAX package's HLO walker), and
the roofline terms and kernel cells built on them (:mod:`roofline`)."""
