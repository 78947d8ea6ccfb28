"""Atomic, async checkpointing of trees of tensors (DESIGN.md §4 fault
tolerance) — the port of ``repro.checkpoint.store``.

* **Layout** (the reference's, byte for byte): one ``.npy`` per tree leaf
  and a JSON manifest (step, extra, and each leaf's file, shape and
  dtype), so a checkpoint written by either package reads back bitwise
  through the other's store.
* **Atomicity**: everything lands in ``<dir>/.tmp-<step>``; the final
  ``rename`` to ``step_<n>`` is the commit point. A crash mid-write leaves
  only a tmp dir that the next writer garbage-collects; ``latest`` never
  points at a torn checkpoint.
* **Async**: ``save_async`` snapshots to host memory synchronously (cheap)
  and writes on a background thread. ``wait()`` joins before the next save
  (single writer).
* **Leaves** may be torch tensors (any device), numpy arrays or Python
  scalars. A tensor goes to the host as ``.detach().cpu().numpy()``: its
  dtype is kept, so f64 and int64 leaves never round. numpy has no
  bfloat16, so a bf16 tensor is written as the reference writes its
  ``ml_dtypes`` bf16 arrays: 2-byte void records holding the bits, with
  ``"bfloat16"`` in the manifest; it restores as a bf16 tensor.
* **Restore** returns numpy leaves exactly as saved with ``host=True``;
  by default each leaf is a tensor on the store's ``device``.
  ``shardings=`` is the reference's reshard-on-restore: a tree like the
  skeleton whose leaves place each leaf on an LM mesh (a ``DTensor``,
  whose mesh and placements are taken: the tree being resumed, or its
  meta-device skeleton; None keeps the leaf whole), and each such leaf
  comes back as a DTensor, every rank keeping its own block of the saved
  whole.
* **Process groups** (a fleet mesh, DESIGN.md §11, or an LM mesh): only
  rank 0 writes, every rank restores, and a barrier separates the two
  (after a synchronous save; at ``wait()`` after an async one). A DTensor
  leaf is saved whole (every rank takes part in gathering it, then rank
  0 copies it to the host), one leaf at a time, so that a device holds at
  most one whole leaf beside its shards; a checkpoint taken on one mesh
  restores onto another mesh, onto any world size, or onto none.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distribution import sharding as sh

PyTree = Any
_SEP = "/"


def _flatten(tree: PyTree) -> dict[str, Any]:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + [str(i)], v)
        else:
            flat[_SEP.join(path)] = node

    walk([], tree)
    return flat


def _unflatten_into(skeleton: PyTree, flat: dict[str, Any]) -> PyTree:
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + [str(k)], v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(path + [str(i)], v) for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return tuple(walk(path + [str(i)], v) for i, v in enumerate(node))
        return flat[_SEP.join(path)]

    return walk([], skeleton)


class CheckpointStore:
    """Directory of step_<n> checkpoints with a single async writer.
    ``device`` is where ``restore`` puts tensors by default (the CPU unless
    given)."""

    def __init__(self, directory: str | Path, *, keep: int = 3, device=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.device = torch.device(device if device is not None else "cpu")
        self._thread: Optional[threading.Thread] = None
        self._pending = False      # an async save not yet waited for
        self.last_write_s = 0.0

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree, *, extra: Optional[dict] = None) -> Path:
        self.wait()
        final = self.dir / f"step_{step:08d}"
        host_flat = _host_leaves(tree)
        if host_flat is not None:
            final = self._write(step, host_flat, extra or {})
        sh.barrier()
        return final

    def save_async(self, step: int, tree: PyTree, *, extra: Optional[dict] = None) -> None:
        self.wait()
        self._pending = True
        host_flat = _host_leaves(tree)  # snapshot before returning
        if host_flat is None:
            return

        def run():
            self._write(step, host_flat, extra or {})

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            sh.barrier()

    def _write(self, step: int, host_flat: dict[str, np.ndarray], extra: dict) -> Path:
        t0 = time.perf_counter()
        for stale in self.dir.glob(".tmp-*"):
            shutil.rmtree(stale, ignore_errors=True)  # GC torn writes
        tmp = self.dir / f".tmp-{step}"
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for i, (key, arr) in enumerate(sorted(host_flat.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": "bfloat16" if arr.dtype == _BF16_BITS
                else str(arr.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # commit point
        self._gc()
        self.last_write_s = time.perf_counter() - t0
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def leaf_keys(self, step: Optional[int] = None) -> set[str]:
        """Flat key set of a saved checkpoint (no leaf data loaded) — lets a
        caller trim optional template keys (e.g. §16 shield carry) before
        ``restore`` when resuming from a checkpoint that predates them."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        return set(manifest["leaves"])

    def restore(self, skeleton: PyTree, *, step: Optional[int] = None,
                shardings: Optional[PyTree] = None,
                host: bool = False) -> tuple[PyTree, int, dict]:
        """Load into the structure of ``skeleton``. ``host=True`` returns
        the numpy leaves exactly as saved; the default returns each leaf as
        a tensor on the store's device, of the saved dtype, and with
        ``shardings`` (a tree like ``skeleton``; see the module docstring)
        each placed leaf as a DTensor of the rank's own block."""
        if shardings is not None and host:
            raise ValueError("restore: host=True returns numpy leaves; "
                             "shardings= places tensors")
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        layouts = {} if shardings is None else _flatten(shardings)
        flat = {}
        for key, info in manifest["leaves"].items():   # a leaf at a time
            arr = np.load(d / info["file"])
            flat[key] = arr if host else _place(
                _to_device(arr, self.device, info["dtype"]), layouts.get(key))
        tree = _unflatten_into(skeleton, flat)
        return tree, manifest["step"], manifest.get("extra", {})


#: how a bf16 leaf lies in numpy: its bits as 2-byte void records
_BF16_BITS = np.dtype("V2")


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(_BF16_BITS)
        return v.numpy()
    return np.asarray(v)


def _host_leaves(tree: PyTree) -> Optional[dict[str, np.ndarray]]:
    """The tree's leaves on the host, on the writer (None on the other
    ranks), taken one leaf at a time: a DTensor leaf is gathered whole (a
    collective every rank of its mesh takes part in), copied to the host
    and dropped before the next, so that a device never holds more than
    one whole leaf beside its shards."""
    writer = sh.is_writer()
    out = {}
    for k, v in _flatten(tree).items():
        v = sh.whole(v)
        if writer:
            out[k] = _to_numpy(v)
        del v
    return out if writer else None


def _place(t: torch.Tensor, where) -> torch.Tensor:
    """``t`` (the whole leaf, the same on every rank) as a DTensor with the
    mesh and placements of the DTensor ``where``, with no communication,
    its block a copy (a view would keep the whole leaf alive); ``t``
    itself when ``where`` is None."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if where is None:
        return t
    x = distribute_tensor(t, where.device_mesh, list(where.placements),
                          src_data_rank=None)
    return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _to_device(arr: np.ndarray, device: torch.device,
               dtype: str) -> torch.Tensor:
    """A saved leaf as a tensor of its own dtype on ``device``."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)
