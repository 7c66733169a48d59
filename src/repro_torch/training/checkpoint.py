"""Fault-tolerant checkpointing: atomic npz snapshots with a JSON
manifest, asynchronous (off the critical path) writes, and restore of
the latest checkpoint onto the devices of a template tree.

Layout (the JAX package's, so a tree of dicts written by either package
loads in the other):

    <dir>/step_00001230/
        manifest.json     {"step": ..., "leaf_paths": [...], "extra": ...}
        arrays.npz        one entry per leaf, named by its key path
                          ("params/embed/table"); a bfloat16 leaf is
                          stored as uint16 under "<path>::bf16"
    <dir>/LATEST          text file: "step_00001230"

Writes go to ``<name>.tmp`` and are committed with an atomic rename, so
a job killed mid-save never corrupts the previous checkpoint. Trees are
nested dicts (keys in sorted order), lists and tuples of tensors; a
``None`` is an empty subtree, as in a JAX pytree. A leaf placed across a
mesh (:class:`repro_torch.models.sharding.Placed`) is gathered whole to
the host as it is written, so the files are those a whole state writes;
:func:`load_checkpoint`'s ``shardings`` places each leaf as it is read.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import sharding as sh


def _flatten_with_paths(tree, keep_none: bool = False
                        ) -> Tuple[List[str], List[Any]]:
    """(key paths, leaves) in the JAX package's order: dict keys sorted,
    sequences by index, paths joined with "/"; ``keep_none`` keeps a
    ``None`` as a leaf (a shardings tree's unplaced entry)."""
    keys, leaves = [], []

    def walk(node, path):
        if node is None and not keep_none:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            keys.append("/".join(path))
            leaves.append(node)

    walk(tree, ())
    return keys, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}       # the template's order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """A leaf as a host numpy array, and whether it was bfloat16 (then
    the array is its bits as uint16)."""
    if sh.is_placed(leaf):
        leaf = sh.whole(leaf, "cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _to_host(leaf):
    """A snapshot of a leaf that later writes to the original cannot
    touch."""
    if sh.is_placed(leaf):
        return sh.whole(leaf, "cpu")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def save_checkpoint(ckpt_dir: str, state, step: int,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    keys, leaves = _flatten_with_paths(state)
    arrays = {}
    for k, leaf in zip(keys, leaves):
        a, bf16 = _to_numpy(leaf)
        arrays[k + "::bf16" if bf16 else k] = a
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": int(step), "leaf_paths": keys,
                   "extra": extra or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def load_checkpoint(ckpt_dir: str, like, step: Optional[int] = None,
                    device=None, shardings=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included). Each leaf takes the file's dtype and lands on
    ``device`` when given, else on the device of ``like``'s leaf at that
    path (the CPU where that leaf is not a tensor). ``shardings``, a tree
    like ``like`` of :class:`repro_torch.models.sharding.NamedSharding`
    (``None`` entries read as above), places each leaf as it is read (the
    JAX package's ``shardings``): no whole copy of it outlives the read.
    Returns (tree, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    keys, leaves = _flatten_with_paths(like)
    places = ([None] * len(keys) if shardings is None
              else _flatten_with_paths(shardings, keep_none=True)[1])
    if len(places) != len(keys):
        raise ValueError(f"shardings has {len(places)} leaves, the "
                         f"template {len(keys)}")
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for k, leaf, where in zip(keys, leaves, places):
            if k in data:
                t = torch.from_numpy(data[k])
            elif k + "::bf16" in data:
                t = torch.from_numpy(data[k + "::bf16"].view(np.int16)).view(
                    torch.bfloat16)
            else:
                raise KeyError(f"checkpoint missing leaf {k}")
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {k} has shape "
                                 f"{tuple(t.shape)}, the template "
                                 f"{tuple(leaf.shape)}")
            if where is not None:
                out.append(sh.put(t, where))
                continue
            dev = (torch.device(device) if device is not None
                   else leaf.device if isinstance(leaf, torch.Tensor)
                   else torch.device("cpu"))
            out.append(t.to(dev))
    return _unflatten(like, out), manifest


def gc_old_checkpoints(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; the caller only blocks
    to copy the state to the host, never on disk I/O. At most one save
    in flight: a newer request while busy is queued, older pending ones
    are dropped. The worker clears ``_thread`` under the lock as it
    finds nothing pending, so a save made while it exits starts a new
    worker rather than wait on a finished one."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._lock = threading.Lock()
        self._pending = None
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save(self, state, step: int, extra=None):
        host_state = _unflatten(
            state, [_to_host(x) for x in _flatten_with_paths(state)[1]])
        with self._lock:
            self._pending = (host_state, step, extra)
            if self._thread is None:
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self):
        while True:
            with self._lock:
                item, self._pending = self._pending, None
                if item is None:
                    self._thread = None
                    return
            try:
                save_checkpoint(self.ckpt_dir, item[0], item[1], item[2])
                gc_old_checkpoints(self.ckpt_dir, self.keep)
            except Exception as e:      # the worker's boundary: kept for
                self.last_error = e     # the caller, as the JAX package does

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait for the saves requested so far; False if ``timeout``
        seconds passed first."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True
