"""Fault-tolerant checkpointing, in the reference's on-disk layout.

Port of ``repro/ckpt/manager.py``: ``step_N/`` holds one ``.npy`` per
array plus ``meta.json`` (per-array crc32, shape, dtype, and the caller's
``extra`` metadata), so a checkpoint written by either package restores in
the other. Array names are the state tree's paths joined by "/" exactly as
the reference spells them (dict keys and list indices as-is, NamedTuple
fields with a leading "."), e.g. ``shards/0/.keys``.

  * atomic: write step_N.tmp/, fsync every file and the directories,
    os.replace -> step_N/;
  * integrity: crc32 verified on restore; a corrupt step is skipped;
  * keep-last-k pruning and optional background saves, under one lock so
    a save's prune never deletes a step a restore is reading.

Tensors are copied to the host (``.cpu().numpy()``) to be saved; restored
arrays land on the device of the template's leaves. A placed state (each
rank holding blocks, ``launch/sharding.py``) is saved with its
``shardings``: the leaves are gathered whole one at a time, rank 0 of
the mesh copies each to the host and writes them; ``restore_step`` / ``restore_latest`` with ``shardings`` cut
each whole array to this rank's block, so a checkpoint written on one
mesh restores onto another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} in the reference's path spelling and leaf order."""
    join = (lambda k: f"{prefix}{_SEP}{k}") if prefix else (lambda k: str(k))
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], join(k)))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            out.update(_flatten(v, join("." + name)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, join(i)))
    else:
        out[prefix] = tree
    return out


def _unflatten(template, arrays: dict, prefix: str = ""):
    """Rebuild ``template``'s structure from {path: numpy array}; each leaf
    goes to its template leaf's device (CPU for non-tensor leaves)."""
    join = (lambda k: f"{prefix}{_SEP}{k}") if prefix else (lambda k: str(k))
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, join(k))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, arrays, join("." + name))
                                for name, v in zip(template._fields,
                                                   template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, arrays, join(i))
                              for i, v in enumerate(template))
    dev = (template.device if isinstance(template, torch.Tensor)
           else torch.device("cpu"))
    a = arrays[prefix]
    if not a.flags.c_contiguous:    # (np.ascontiguousarray turns 0-d 1-d)
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a).to(dev)


def _mesh_of(shardings):
    return next(iter(_flatten(shardings).values())).mesh


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread = None
        # serializes write/prune against restore reads (RLock: _write
        # calls _prune while holding it)
        self._lock = threading.RLock()

    # ------------------------------------------------------------- save
    def save(self, step: int, state, blocking: bool = True,
             extra_meta: dict | None = None, shardings=None):
        """Copy to host and persist; with blocking=False the files are
        written on a background thread. ``extra_meta`` (JSON-able) is
        stored under meta.json["extra"]. ``shardings`` (the state's
        ``NamedSharding`` tree): the state is this rank's blocks; every
        rank of the mesh must call ``save``, and only its rank 0 writes."""
        self.wait()
        if shardings is None:
            if step in self.list_steps():
                return
            host = {k: _to_host(v) for k, v in _flatten(state).items()}
        else:
            host = self._gather_to_host(state, shardings)
            if host is None or step in self.list_steps():
                return
        if blocking:
            self._write(step, host, extra_meta)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra_meta),
                daemon=True)
            self._thread.start()

    @staticmethod
    def _gather_to_host(state, shardings):
        """The whole leaves of a placed state on the host of the mesh's
        rank 0 (None on the other ranks): one leaf at a time is gathered
        (a collective over the axes its spec names), copied to the host on
        rank 0 and dropped, so no rank holds more than one whole leaf on
        its device at once."""
        from repro_torch.launch.sharding import whole_of
        mesh = _mesh_of(shardings)
        specs = _flatten(shardings)
        host = {}
        for k, v in _flatten(state).items():
            whole = whole_of(v, specs[k].spec, mesh)
            if mesh.rank == 0:
                host[k] = _to_host(whole)
            del whole
        return host if mesh.rank == 0 else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _fsync_dir(path: str):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _write(self, step: int, host: dict, extra_meta: dict | None = None):
        with self._lock:
            final = os.path.join(self.dir, f"step_{step:010d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            meta = {"step": step, "arrays": {}, "extra": extra_meta or {}}
            for k, v in host.items():
                fn = k.replace(_SEP, "__") + ".npy"
                # fsync each array file: the rename only orders the
                # directory entry, not the array bytes
                with open(os.path.join(tmp, fn), "wb") as f:
                    np.save(f, v)
                    f.flush()
                    os.fsync(f.fileno())
                meta["arrays"][k] = {
                    "file": fn, "crc": zlib.crc32(v.tobytes()) & 0xFFFFFFFF,
                    "shape": list(v.shape), "dtype": str(v.dtype)}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            self._fsync_dir(tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._fsync_dir(self.dir)
            self._prune()

    def _prune(self):
        with self._lock:
            steps = self.list_steps()
            for s in steps[:-self.keep]:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                              ignore_errors=True)

    # ---------------------------------------------------------- restore
    def list_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def read_meta(self, step: int | None = None):
        """(step, meta dict) of the given, else the newest readable,
        checkpoint, without loading arrays. Raises FileNotFoundError when
        none is readable."""
        steps = [step] if step is not None else reversed(self.list_steps())
        for s in steps:
            try:
                with self._lock, \
                        open(os.path.join(self.dir, f"step_{s:010d}",
                                          "meta.json")) as f:
                    return s, json.load(f)
            except (OSError, ValueError):   # missing OR corrupt json
                continue
        raise FileNotFoundError(f"no readable checkpoint under {self.dir}")

    def _load(self, step: int):
        with self._lock:
            d = os.path.join(self.dir, f"step_{step:010d}")
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            arrays = {}
            for k, info in meta["arrays"].items():
                v = np.load(os.path.join(d, info["file"]))
                if (zlib.crc32(v.tobytes()) & 0xFFFFFFFF) != info["crc"]:
                    raise IOError(f"checksum mismatch for {k} at step {step}")
                arrays[k] = v
            return meta["step"], arrays

    def restore_step(self, step: int, template, shardings=None):
        """Restore ONE step into ``template``'s structure, or None if that
        step is corrupt or partial. ``shardings`` (a ``NamedSharding``
        tree of the template's structure): each array is cut to this
        rank's block."""
        try:
            step, arrays = self._load(step)
        except (OSError, ValueError, KeyError, EOFError) as e:
            print(f"[ckpt] skipping step {step}: {e}")
            return None
        missing = set(_flatten(template)) - set(arrays)
        if missing:
            print(f"[ckpt] step {step} missing {len(missing)} arrays")
            return None
        if shardings is not None:
            from repro_torch.launch.sharding import block_of
            for k, sh in _flatten(shardings).items():
                arrays[k] = block_of(torch.from_numpy(arrays[k]), sh.spec,
                                     sh.mesh).numpy()
        return _unflatten(template, arrays)

    def restore_latest(self, template, shardings=None):
        """Newest intact checkpoint -> (state, step), or (None, -1)."""
        for step in reversed(self.list_steps()):
            state = self.restore_step(step, template, shardings)
            if state is not None:
                return state, step
        return None, -1
