"""Fault-tolerant checkpointing (``repro``'s ``checkpoint/manager.py``,
with its on-disk layout):

- atomic commit: write to step_XXXXXXXX.tmp/, fsync the manifest, rename;
  a crash mid-write never corrupts the latest checkpoint,
- CRC32 per array + ``manifest.json``; restore skips corrupt checkpoints
  and falls back to the newest valid one,
- async save thread (training never blocks on disk; the arrays are copied
  to the host before the thread starts, so the step may update them in
  place), the newest ``keep`` checkpoints kept.

A tree is ``repro``'s: dicts (sorted keys) and lists of leaves, in
``jax.tree.flatten``'s order, each array ``{i:05d}.npy`` under the key
``{i:05d}:{path}`` that ``repro`` writes.  An ``nn.Module`` stands for its
``param_tree()``, whose tuple leaves (a tensor a layer) are written
stacked ``[L, ...]`` as ``repro`` holds them; bfloat16 tensors are written
as float32 (exact; numpy has no bfloat16).  So a checkpoint written by
either package restores in the other.  Restore writes into the tensors
and modules of the tree it is given (``proto_tree``) and returns that
tree; numpy leaves come back as the arrays read.  Elastic re-sharding onto
a mesh (``shardings``) is ROADMAP.md §1 item 12.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch
from torch import nn

from repro_torch.not_ported import not_ported


def _items(tree, path: str = ""):
    """(path, leaf) pairs in ``jax.tree.flatten``'s order; ``path`` as
    ``repro`` names it (``['params'].['layers'].[0]``)."""
    if isinstance(tree, nn.Module):
        tree = tree.param_tree()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{path}.[{k!r}]" if path
                              else f"[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}.[{i}]" if path else f"[{i}]")
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own (a tuple leaf stacked)."""
    if isinstance(leaf, tuple):
        return np.stack([_host(t) for t in leaf])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf)


def host_arrays(tree) -> dict[str, np.ndarray]:
    """The tree's leaves as host copies under ``repro``'s keys."""
    return {f"{i:05d}:{p}": _host(v) for i, (p, v) in enumerate(_items(tree))}


def _put(leaf, arr: np.ndarray):
    if isinstance(leaf, tuple):
        if arr.shape[0] != len(leaf):
            raise ValueError(f"checkpoint: {arr.shape[0]} layers stored, "
                             f"{len(leaf)} expected")
        return tuple(_put(t, a) for t, a in zip(leaf, arr))
    if isinstance(leaf, torch.Tensor):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint: an array of shape {arr.shape} "
                             f"for a tensor of shape {tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(torch.from_numpy(np.array(arr)))
        return leaf
    return arr


def load_arrays(flat: dict, proto):
    """``proto`` with the arrays of ``flat`` (keys sorted) in its leaves:
    tensors and modules written in place, numpy leaves replaced."""
    arrays = [flat[k] for k in sorted(flat)]
    n = sum(1 for _ in _items(proto))
    if len(arrays) != n:
        raise ValueError(f"checkpoint: {len(arrays)} arrays for a tree of "
                         f"{n} leaves")
    it = iter(arrays)

    def fill(t):
        if isinstance(t, nn.Module):
            fill(t.param_tree())
            return t
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return _put(t, next(it))

    return fill(proto)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: dict | None = None,
             block: bool = False):
        flat = host_arrays(tree)
        if self._thread is not None:
            self._thread.join()  # one in flight at a time
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}))
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "arrays": {}}
        for k, v in flat.items():
            fn = k.split(":", 1)[0] + ".npy"
            np.save(os.path.join(tmp, fn), v)
            with open(os.path.join(tmp, fn), "rb") as f:
                crc = zlib.crc32(f.read())
            manifest["arrays"][k] = {
                "file": fn, "crc": crc, "shape": list(v.shape),
                "dtype": str(v.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _verify_and_load(self, step: int):
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for k, meta in manifest["arrays"].items():
            fp = os.path.join(path, meta["file"])
            with open(fp, "rb") as f:
                if zlib.crc32(f.read()) != meta["crc"]:
                    raise IOError(f"CRC mismatch in {fp}")
            flat[k] = np.load(fp)
        return manifest, flat

    def restore(self, proto_tree, shardings=None):
        """Newest valid checkpoint -> (step, tree, extra), the arrays
        written into ``proto_tree``; (None, None, None) if nothing is
        usable."""
        if shardings is not None:
            raise not_ported("mesh")
        for step in reversed(self.list_steps()):
            try:
                manifest, flat = self._verify_and_load(step)
            except Exception:
                continue  # corrupt -> fall back to an older checkpoint
            tree = load_arrays(flat, proto_tree)
            return manifest["step"], tree, manifest["extra"]
        return None, None, None


def restore_latest(directory: str, proto_tree, shardings=None):
    return CheckpointManager(directory).restore(proto_tree, shardings)
