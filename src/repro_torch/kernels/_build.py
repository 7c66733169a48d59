"""Builds the port's CUDA kernels into one shared library at first use.

Every ``.cu`` file under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into
one ``.so`` with a plain C interface, and loaded with :mod:`ctypes`.
The library lands in ``build/kernels/`` at the repository root, named
after a digest of every file under ``csrc`` (headers included) and the
flags, so an edited source or header rebuilds and an unchanged tree
loads at once. Nothing here runs at import time:
the CPU tests import every module, and this machine class has no
``nvcc``.
"""
from __future__ import annotations

import contextlib
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
    "histogram_bin_u8": (_P, _L, _L, _I, _I, _P, _P, _P, _P),
    "histogram_bin_i32": (_P, _L, _L, _I, _I, _P, _P, _P, _P),
    "histogram_bin_block_bytes": (),
    "histogram_bin_max_cluster": (),
    "histogram_bin_blocks": (_L, _I),
    "labels_f32": (_P, _L, _L, _P, _I, _I, _P, _P),
    "labels_u8": (_P, _L, _L, _P, _I, _I, _P, _P),
    "labels_i32": (_P, _L, _L, _P, _I, _I, _P, _P),
    "labels_block_pixels": (),
    "fcm_resident_solve": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                           _I, _P, _P, _P, _P),
    "fcm_resident_max_rows": (),
    "fcm_resident_threads": (),
    "fcm_membership": (_P, _L, _P, _I, _F, _F, _P, _P),
    "fcm_center_partials": (_P, _P, _P, _L, _I, _F, _P, _I, _P, _P, _P,
                            _P),
    "fcm_fused_partials": (_P, _P, _L, _P, _I, _F, _F, _I, _I, _P, _P, _P,
                           _P, _P),
    "fcm_fused_partials_batched": (_P, _P, _I, _L, _I, _P, _I, _F, _F, _I,
                                   _I, _P, _P, _P, _P, _P),
    "fcm_batched_threads": (),
    "fcm_batched_max_blocks": (),
    "fcm_batched_tier": (_I, _I),
    "fcm_batched_dchunk": (_I, _I),
    "fcm_batched_rows_per_thread": (_I, _I, _I),
    "fcm_max_c": (),
    "fcm_streamed_solve": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                           _I, _I, _P, _P, _P, _P, _P, _P),
    "fcm_streamed_max_rows": (),
    "fcm_streamed_max_c": (),
    "fcm_streamed_max_feat": (),
    "fcm_streamed_threads": (),
    "fcm_streamed_max_ranks": (),
    "fcm_streamed_rows_per_block": (_I,),
    "fcm_streamed_min_blocks": (_I, _I),
    "fcm_streamed_blocks_per_sm": (_I, _I, _F),
    "fcm_streamed_registers": (_I, _I, _F),
    "slic_assign": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P),
    "slic_max_center_bytes": (),
    "slic_tile_w": (),
    "slic_tile_h": (),
    "slic_window_slack": (),
    "fcm_spatial_partials_2d": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I,
                                _P, _P, _P, _P),
    "fcm_spatial_partials_3d": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I,
                                _P, _P, _P),
    "fcm_spatial2d_strip_w": (),
    "fcm_spatial2d_warps": (),
    "fcm_spatial2d_max_warp_rows": (),
    "fcm_spatial2d_blocks": (_I, _I, _I),
    "fcm_spatial3d_tile_w": (),
    "fcm_spatial3d_tile_h": (),
    "fcm_spatial3d_tile_bytes": (),
    "fcm_spatial3d_rows": (_I, _I, _I, _I),
    "fcm_stencil_solve": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                          _I, _I, _I, _P, _P, _P, _P),
    "fcm_stencil_max_pixels": (),
    "fcm_stencil_max_c": (),
    "fcm_stencil_max_cluster": (),
    "fcm_stencil_smem_bytes": (_I, _I, _I, _I, _I, _I),
    "fcm_stencil_active_clusters": (_I, _I, _I, _I, _I, _I, _I),
    "selective_scan_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                           _P, _P, _P),
}

#: return types other than int
RESTYPES = {"fcm_stencil_smem_bytes": _L, "fcm_spatial3d_rows": _L,
            "fcm_spatial2d_blocks": _L, "histogram_bin_block_bytes": _L,
            "histogram_bin_blocks": _L}


class KernelBuildError(RuntimeError):
    """The kernel library could not be had: ``nvcc`` is missing, a source
    fails to compile, the link fails, the build directory cannot be
    written, or the library does not load or lacks a symbol."""


class KernelLaunchError(RuntimeError):
    """A kernel returned a nonzero ``cudaError_t``."""


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
    raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed (set "
                           "CUDA_HOME)")


def sources():
    """The translation units: every ``.cu`` file under ``csrc``."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """A digest of the flags and of every file under ``csrc`` (sources
    and the headers they include), so editing either rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> str:
    """Compile every source in parallel, link them into ``out``; returns
    the compilers' combined report. Raises :class:`KernelBuildError` with
    the report on failure."""
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            try:
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            except OSError as e:
                for _, _, proc in procs:
                    proc.kill()
                    proc.wait()
                raise KernelBuildError(f"cannot run {nvcc}: {e}") from e
        logs, failed = [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        report = "\n".join(logs)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n{report}")
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *[str(obj) for _, obj, _ in procs], "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(
                f"linking the kernels failed:\n{link.stdout}")
        os.replace(staged, out)     # atomic: concurrent builders agree
    return report


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Raises
    :class:`KernelBuildError` if the build or the load fails; there is no
    fallback."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = BUILD_DIR / f"libfcm_kernels-{_digest()}.so"
            if not path.exists():
                t0 = time.perf_counter()
                build_log = _compile(_nvcc(), path)
                build_seconds = time.perf_counter() - t0
        except OSError as e:
            raise KernelBuildError(f"cannot build the kernels in "
                                   f"{BUILD_DIR}: {e}") from e
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        for name, args in SIGNATURES.items():
            try:
                fn = getattr(lib, name)
            except AttributeError as e:
                raise KernelBuildError(
                    f"{path} lacks the symbol {name}") from e
            fn.argtypes = list(args)
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` if a launch returned a nonzero
    ``cudaError_t``."""
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA launch failed with "
                                f"cudaError_t {err}")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


_ALREADY = contextlib.nullcontext()


def on_device(t):
    """The context every library call for ``t`` (a tensor, or a device)
    runs in: ``torch.cuda.device`` of its card for CUDA, a null context
    otherwise or when that card is already current. The library's
    ``<<<>>>`` launches and its attribute and occupancy queries go to the
    calling thread's *current* device, and :func:`stream_of` hands it a
    stream of ``t``'s device; under this guard the two are one card
    whatever device the caller has current."""
    import torch
    dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
    if dev.type != "cuda" or dev.index == torch.cuda.current_device():
        return _ALREADY
    return torch.cuda.device(dev)


#: (device, stream) -> the int32 counters the kernels there share
_counters = {}


def zeroed_ints(t, n: int):
    """At least ``n`` int32 counters on ``t``'s device that are zero when a
    kernel on the current stream starts. The kernels that take them (the
    streamed whole-solve's per-lane barriers, the center partials' ticket,
    the per-lane tickets of the batched fused partials and the 2-D FCM_S
    step)
    set every counter they touch back to zero before they exit, and
    kernels on one stream run in turn, so one buffer, zeroed once, serves
    every later launch on that stream."""
    import torch
    key = (t.device, stream_of(t))
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 256),), dtype=torch.int32, device=t.device)
        _counters[key] = buf
    return buf


def lane_chunks(b: int, most: int):
    """``(i0, i1)`` slices of ``b`` lanes, each of at most ``most`` lanes,
    in order: one launch each, for a kernel whose lanes sit on a grid axis
    capped at 65535."""
    return [(i0, min(b, i0 + most)) for i0 in range(0, b, most)]
