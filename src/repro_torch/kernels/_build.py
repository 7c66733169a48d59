"""Builds the port's CUDA kernels into one shared library at first use.

Every ``.cu`` file under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into
one ``.so`` with a plain C interface, and loaded with :mod:`ctypes`.
The library lands in ``build/kernels/`` at the repository root, named
after a digest of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once. Nothing here runs at import time:
the CPU tests import every module, and this machine class has no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C signatures of the exported functions (every one returns cudaError_t).
SIGNATURES = {
    "histogram_bin_u8": (_P, _L, _L, _I, _L, _P, _P),
    "histogram_bin_i32": (_P, _L, _L, _I, _L, _P, _P),
    "labels_f32": (_P, _L, _L, _P, _I, _P, _P),
    "labels_u8": (_P, _L, _L, _P, _I, _P, _P),
    "labels_i32": (_P, _L, _L, _P, _I, _P, _P),
    "fcm_resident_solve": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                           _P, _P, _P, _P),
    "fcm_resident_max_rows": (),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: ptxas' report (registers, shared memory, spills per kernel) of the
#: build that produced the loaded library; empty when it was cached.
build_log = ""
#: seconds the last build took (0.0 when the library was cached).
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed (set CUDA_HOME)")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> str:
    """Compile every source in parallel, link them into ``out``; returns
    the compilers' combined report. Raises with the report on failure."""
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        report = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *[str(obj) for _, obj, _ in procs], "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(staged, out)     # atomic: concurrent builders agree
    return report


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Raises if the
    build fails; there is no fallback."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"libfcm_kernels-{_digest()}.so"
        if not path.exists():
            t0 = time.perf_counter()
            build_log = _compile(_nvcc(), path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
