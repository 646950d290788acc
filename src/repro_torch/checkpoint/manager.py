"""Checkpointing: atomic, async, resumable — the port's copy of
``repro/checkpoint/manager.py`` without JAX.

Layout (one directory per step), the same on disk as the reference's, so a
checkpoint written by one package is read leaf for leaf by the other::

    <root>/step_00000123/
        manifest.json         # leaf paths, shapes, dtypes
        leaf_000000.npy ...   # one file per leaf (host-local full arrays)
    <root>/LATEST             # text file holding the last committed step

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
scalars or torch tensors.  Leaves are flattened in the order
``jax.tree_util`` uses — dict keys sorted, sequences in index order,
``None`` holding no leaf — and each leaf's path is its keys / indices
joined by ``/``, as the reference writes them.

Writes are crash-safe: leaves are written into ``step_X.tmp`` and the
directory is ``os.rename``d only after everything (incl. the manifest) is
fsynced, so a process killed mid-save leaves the previous checkpoint
intact.  Saving may run on a background thread; the writer's critical
sections (claiming a pending save, committing LATEST) are guarded by a
:class:`~repro_torch.core.mutlock.MutableLock` — commit is µs-scale
(spin-friendly) while serialization is ms-scale I/O (sleep-friendly).

Restore returns numpy arrays in the template's structure and dtypes; the
caller moves them to a device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.core.mutlock import MutableLock
from repro_torch.core.waitpolicy import MutableWait


# --------------------------------------------------------------------------
# Tree <-> flat leaves with stable paths
# --------------------------------------------------------------------------
def _flatten_with_paths(tree, prefix=()):
    """``(path, leaf)`` pairs in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _unflatten(template, leaves):
    """Rebuild ``template``'s structure from an iterator over its leaves,
    visited in the order of :func:`_flatten_with_paths`."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if template is None:
        return None
    return next(leaves)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:    # numpy has no bfloat16
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return _to_numpy(torch.empty((), dtype=leaf.dtype)).dtype
    return np.dtype(leaf.dtype)


def _resolve_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes                  # bfloat16 / fp8 extension dtypes
        return np.dtype(getattr(ml_dtypes, name))


def _is_native(dt: np.dtype) -> bool:
    try:
        return np.dtype(str(dt)) == dt and dt.kind != "V"
    except TypeError:
        return False


def save_pytree(tree, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"leaves": []}
    for i, (p, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:06d}.npy"
        if _is_native(arr.dtype):
            np.save(os.path.join(out_dir, fname), arr)
            raw = False
        else:                              # bfloat16 etc: store raw bytes
            np.save(os.path.join(out_dir, fname),
                    np.frombuffer(arr.tobytes(), np.uint8))
            raw = True
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype), "raw": raw})
    tmp = os.path.join(out_dir, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(out_dir, "manifest.json"))


def load_pytree(in_dir: str, template):
    """Restore into the structure and dtypes of ``template`` (a tree of
    arrays, tensors, or objects with ``.shape`` and ``.dtype``); every leaf
    comes back as a numpy array."""
    with open(os.path.join(in_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for p, tleaf in _flatten_with_paths(template):
        e = by_path.get(p)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = np.load(os.path.join(in_dir, e["file"]))
        if e.get("raw"):
            arr = np.frombuffer(arr.tobytes(),
                                _resolve_dtype(e["dtype"])).reshape(
                tuple(e["shape"]))
        if tuple(arr.shape) != tuple(tleaf.shape):
            raise ValueError(f"shape mismatch for {p}: ckpt {arr.shape} "
                             f"vs template {tuple(tleaf.shape)}")
        dtype = _np_dtype(tleaf)
        out.append(arr if arr.dtype == dtype else arr.astype(dtype))
    return _unflatten(template, iter(out))


# --------------------------------------------------------------------------
# Manager
# --------------------------------------------------------------------------
class CheckpointManager:
    def __init__(self, root: str, keep_last: int = 3,
                 async_save: bool = True):
        self.root = root
        self.keep_last = keep_last
        self.async_save = async_save
        os.makedirs(root, exist_ok=True)
        self.lock = MutableLock(max_sws=2)
        self._pending: tuple[int, object] | None = None
        self._inflight = False
        self._stop = threading.Event()
        self._saved_evt = threading.Event()
        self.save_count = 0
        self.last_save_s = 0.0
        if async_save:
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()

    # -- public API -----------------------------------------------------------
    def save(self, step: int, state) -> None:
        """Snapshot state (the device -> host copy happens here,
        synchronously, so the caller may overwrite device buffers
        afterwards)."""
        leaves = iter([_to_numpy(x) for _, x in _flatten_with_paths(state)])
        host_state = _unflatten(state, leaves)
        if not self.async_save:
            self._write(step, host_state)
            return
        with self.lock:
            self._pending = (step, host_state)   # newest-wins coalescing
        self._saved_evt.clear()

    def wait(self, timeout_s: float = 60.0) -> bool:
        """Block until the queued save (if any) is committed."""
        if not self.async_save:
            return True
        w = MutableWait(max_spin_s=1e-3, sleep_s=5e-3)
        return w.wait(lambda: self._pending is None and not self._inflight,
                      timeout_s=timeout_s)

    def latest_step(self) -> int | None:
        path = os.path.join(self.root, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, template, step: int | None = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.root, f"step_{step:08d}")
        return step, load_pytree(d, template)

    def close(self) -> None:
        self._stop.set()
        if self.async_save:
            self._thread.join(timeout=10.0)

    # -- writer side ----------------------------------------------------------
    def _writer(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                job, self._pending = self._pending, None
                if job is not None:
                    self._inflight = True
            if job is None:
                time.sleep(2e-3)
                continue
            try:
                self._write(*job)
            finally:
                self._inflight = False

    def _write(self, step: int, host_state) -> None:
        t0 = time.monotonic()
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(host_state, tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with self.lock:                       # commit LATEST atomically
            lp = os.path.join(self.root, "LATEST.tmp")
            with open(lp, "w") as f:
                f.write(str(step))
                f.flush()
                os.fsync(f.fileno())
            os.rename(lp, os.path.join(self.root, "LATEST"))
            self.save_count += 1
            self.last_save_s = time.monotonic() - t0
        self._gc()
        self._saved_evt.set()

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
