"""Target-hardware constants: one NVIDIA H100 SXM (80 GB HBM3), from its
data sheet, and the DGX H100 node it sits in."""

import torch

PEAK_FLOPS_BF16 = 989.4e12    # dense bf16 on the tensor cores, per GPU
PEAK_FLOPS_F32 = 67e12        # float32 on the CUDA cores, per GPU
HBM_BW = 3.35e12              # bytes/s per GPU
HBM_BYTES = 80e9              # 80 GB per GPU
NVLINK_BW = 450e9             # bytes/s per direction per GPU (NVLink 4)
NET_BW = 50e9                 # bytes/s per direction per GPU: one 400 Gb/s
                              # NIC a GPU, as in a DGX H100
GPUS_PER_NODE = 8

_HLO_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s4": 1, "u4": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def dtype_bytes(dtype) -> int:
    """Bytes an element of ``dtype``: a :class:`torch.dtype`, or an HLO
    element-type name (``"bf16"``, ``"s32"``, ...; 4 for a name it does
    not know, as the JAX package's table)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype, device="meta").element_size()
    return _HLO_BYTES.get(dtype, 4)
