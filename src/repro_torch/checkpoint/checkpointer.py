"""Sharded, async, fault-tolerant checkpointing.

The port of ``repro/checkpoint/checkpointer.py``, writing the reference's
format, so a checkpoint written by either package restores in the other:

- **Sharded**: host ``h`` of ``num_hosts`` writes the leaves whose index
  is ``h`` modulo ``num_hosts`` to ``<dir>/step_N/shard_<h>.npz`` under
  keys ``a<index>``, and ``manifest_<h>.json`` beside it.
- **Named as the reference names them**: a tree is nested dicts (lists
  and tuples by index) of tensors or arrays; leaves are taken in JAX's
  flatten order (every dict's keys sorted, ``None`` no leaf) and named by
  their keys joined with ``/``.  The training loop saves ``{"params",
  "m", "v"}`` in the reference's stacked layout
  (``models/params.py::reference_tree``).
- **Atomic**: writes go to ``step_N.tmp/``, then one ``os.replace``; a
  crash mid-write never corrupts the newest checkpoint.
- **Async**: :meth:`Checkpointer.save_async` copies the tree to host
  memory (or takes a host copy the caller made), then writes it on a
  worker thread while training continues.
- **Integrity**: per-shard SHA-256 in the manifest, verified on restore.

npz cannot hold bf16: such leaves are written upcast to f32 (exact) and
cast back to the target's dtype on restore.  The npz bytes of the two
packages differ only by the zip members' timestamps.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Checkpointer", "SEP"]

SEP = "/"


def _flatten_with_names(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(name, leaf) in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(SEP.join(prefix), tree)]
    return [x for k, v in items for x in _flatten_with_names(v, prefix + (k,))]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf, copy: bool) -> np.ndarray:
    """``leaf`` as a host array; with ``copy`` never a view of it (training
    updates its tensors in place while an async save writes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        # npz can't hold bf16: f32, and restore casts back
        dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        return t.to("cpu", dtype, copy=copy).numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, host_id: int = 0, num_hosts: int = 1,
             extra: Optional[Dict] = None) -> str:
        """Synchronous sharded save of this host's leaves."""
        named = _flatten_with_names(tree)
        tmp = os.path.join(self.directory, f"step_{step:08d}.tmp")
        final = os.path.join(self.directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)

        arrays = {f"a{i}": _to_host(leaf, copy=False) for i, (_, leaf) in enumerate(named)
                  if i % num_hosts == host_id}
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = buf.getvalue()
        digest = hashlib.sha256(blob).hexdigest()
        with open(os.path.join(tmp, f"shard_{host_id:05d}.npz"), "wb") as f:
            f.write(blob)

        manifest = {
            "step": step,
            "num_hosts": num_hosts,
            "num_leaves": len(named),
            "leaf_names": [n for n, _ in named],
            "shard_sha256": {str(host_id): digest},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, f"manifest_{host_id:05d}.json"), "w") as f:
            json.dump(manifest, f)
        # Host 0 commits once all hosts have written (single-host: now).
        if host_id == 0:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        return final

    def save_async(self, step: int, tree, *, copy: bool = True, **kw) -> None:
        """Copy to host memory, then write on a worker thread.  ``copy=False``:
        the caller hands over a tree of host tensors or arrays that nothing
        else updates, written as they are."""
        self.wait()
        host_tree = tree
        if copy:
            named = _flatten_with_names(tree)
            host_tree = _unflatten(tree, iter([_to_host(x, copy=True) for _, x in named]))

        def work():
            try:
                self.save(step, host_tree, **kw)
            except BaseException as e:  # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, step: int, like, *, verify: bool = True):
        """Restore into the structure of ``like`` (leaves: tensors, on any
        device, ``meta`` included): CPU tensors of each leaf's dtype.  The
        manifest's leaf names and each leaf's shape must be ``like``'s."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        named = _flatten_with_names(like)
        leaves: List[Optional[np.ndarray]] = [None] * len(named)
        for fn in sorted(os.listdir(d)):
            if not fn.startswith("shard_"):
                continue
            host_id = int(fn.split("_")[1].split(".")[0])
            with open(os.path.join(d, fn), "rb") as f:
                blob = f.read()
            with open(os.path.join(d, f"manifest_{host_id:05d}.json")) as f:
                man = json.load(f)
            if verify:
                want = man["shard_sha256"][str(host_id)]
                got = hashlib.sha256(blob).hexdigest()
                if want != got:
                    raise IOError(
                        f"checkpoint shard {fn} corrupt: sha {got} != {want}"
                    )
            if man["leaf_names"] != [n for n, _ in named]:
                raise ValueError(f"checkpoint step {step} holds other leaves than "
                                 f"the target tree")
            with np.load(io.BytesIO(blob)) as z:
                for key in z.files:  # keys are a<leafindex>
                    leaves[int(key[1:])] = z[key]
        missing = [i for i, x in enumerate(leaves) if x is None]
        if missing:
            raise IOError(f"checkpoint step {step} missing leaves {missing[:5]}...")

        out = []
        for arr, (name, ref) in zip(leaves, named):
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {name}: shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            out.append(torch.from_numpy(arr.copy()).to(ref.dtype))  # npz: read-only
        return _unflatten(like, iter(out))

    def read_extra(self, step: int) -> Dict:
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest_00000.json")) as f:
            return json.load(f).get("extra", {})

    # ------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
