"""repro_torch: the PyTorch/CUDA port of the FCM segmentation system.

It mirrors the JAX package's layout (``repro_torch.core.solver`` <->
``repro.core.solver`` and so on) and keeps its public names. Plain
tensor code is PyTorch; each TPU kernel on a ported path is a CUDA
kernel written for Hopper (``csrc/``), built with ``nvcc`` at first use
and bound with :mod:`ctypes`, with a plain PyTorch version beside it
that CPU tensors take. Entry points run on the card unless the caller
passes ``device="cpu"``.

The package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
