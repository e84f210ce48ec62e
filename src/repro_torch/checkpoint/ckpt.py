"""Manifest-verified, async checkpointing with restore onto a device.

Layout: <dir>/step_<N>/
  manifest.json          — tree structure, shapes, dtypes, crc32 per leaf,
                           completeness marker (written LAST -> atomic)
  <leaf-path>.npy        — one file per leaf, named by its path in the
                           nested dict, ``__``-joined

Fault-tolerance contract (the reference's, ``repro.checkpoint.ckpt``):
- a crashed save never produces a loadable step (manifest written last,
  into ``step_<N>.tmp``, then renamed)
- a leaf whose bytes no longer match its crc32 raises ``IOError``
- ``keep`` limits retained steps; the save can return before the disk
  write ends (``blocking=False``: a writer thread), so the train loop
  does not wait on the disk

The layout, the file bytes and the manifest are the reference's, so a
checkpoint written by either package restores in the other (the port's
trees have the reference's keys: ``convert.py``). What the port adds:

- **The snapshot is taken before** :func:`save` **returns.** The port's
  AdamW writes parameters and moments in place (``optim/adamw.py``), so a
  writer thread that held the tensors would write a later step's bytes,
  and their crc32 would match them. Every leaf is copied to host memory
  first (a device-to-host copy waits for the device).
- **bfloat16** leaves are written as the reference writes them: the raw
  bits as a ``<V2`` ``.npy`` (``ml_dtypes``' descr, which numpy reads
  back as ``|V2``) with manifest dtype ``"bfloat16"``: same bytes, same
  crc32. :func:`restore` rebuilds the dtype from the manifest
  (the bits viewed as ``torch.bfloat16``); the reference's own restore
  returns the ``|V2`` array, which JAX rejects.
- :func:`restore` places each leaf on ``device`` (default: the card;
  raises without one). The reference's ``shardings`` place nothing on one
  card; on a mesh of processes (``core.compat.ProcessMesh``) each leaf
  becomes the rank's block of it.
- A writer that fails raises its error from the returned thread's
  ``join()`` (and from a blocking save); the reference's thread drops it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.compat import is_process_mesh
from repro_torch.device import resolve_device

_BF16 = "bfloat16"
_BF16_DESCR = "<V2"       # what np.save writes for ml_dtypes' bfloat16


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _unflatten(items):
    root: dict = {}
    for path, val in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return root


def _to_host(x):
    """(numpy array of the leaf's bytes, manifest dtype name): a copy that
    no later in-place write can reach."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.to("cpu", copy=True).numpy()
        if dtype == _BF16:
            arr = arr.view(np.dtype("V2"))
        return arr, dtype
    arr = np.array(x, copy=True)
    return arr, str(arr.dtype)


def _save_npy(path: str, arr: np.ndarray, dtype: str):
    if dtype != _BF16:
        np.save(path, arr)
        return
    # numpy spells a plain void dtype "|V2"; the header must say "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


class _Writer(threading.Thread):
    """The writer thread; ``join()`` raises what the write raised."""

    def __init__(self, write):
        super().__init__(daemon=True)
        self._write = write
        self.error: Optional[Exception] = None

    def run(self):
        try:
            self._write()
        except Exception as e:     # handed to join(), never dropped
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.error is not None:
            raise self.error


def save(directory: str, step: int, tree, *, keep: int = 3,
         blocking: bool = True) -> threading.Thread:
    """Write checkpoint for ``step``. Returns the writer thread. Every leaf
    is on the host before this returns, whatever ``blocking`` says."""
    host_tree = [(p, *_to_host(x)) for p, x in _flatten(tree)]

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for path, arr, dtype in host_tree:
            name = "/".join(path)
            fn = name.replace("/", "__") + ".npy"
            _save_npy(os.path.join(tmp, fn), arr, dtype)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes())
                & 0xFFFFFFFF,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                   # atomic completeness marker
        _gc(directory, keep)

    t = _Writer(_write)
    t.start()
    if blocking:
        t.join()
    return t


def _gc(directory: str, keep: int):
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(d[5:]))
    return sorted(out)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def restore(directory: str, *, step: Optional[int] = None, device=None,
            verify: bool = True, shardings=None):
    """Load a checkpoint; each leaf becomes a tensor of its manifest dtype
    on ``device`` (default: the card; raises without one). ``shardings``:
    the reference's target shardings (a tree of
    ``models.sharding.NamedSharding``, possibly of another mesh than the
    one saved from — elastic restore); one card holds each leaf whole, so a
    sharding of a mesh held as tensor dimensions places nothing, one of a
    mesh of processes keeps the rank's block of the leaf, and a leaf whose
    sharded dimension it does not divide raises the reference's
    ``ValueError``. Returns (step, tree) or (None, None) if nothing
    loadable."""
    device = resolve_device(device)
    steps = latest_steps(directory)
    if not steps:
        return None, None
    step = step if step is not None else steps[-1]
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    sh_flat = dict(("/".join(p), s) for p, s in _flatten(shardings)) \
        if shardings is not None else {}
    items = []
    for name, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        if verify:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption in {name} "
                              f"(crc {crc} != {meta['crc32']})")
        sh = sh_flat.get(name)
        if sh is not None:
            sh.shard_shape(arr.shape)
            if is_process_mesh(sh.mesh):
                # a copy of the block (a scalar stays 0-d)
                arr = np.array(arr[sh.block_index(arr.shape)], order="C")
        items.append((tuple(name.split("/")),
                      _to_tensor(arr, meta["dtype"], device)))
    return step, _unflatten(items)
