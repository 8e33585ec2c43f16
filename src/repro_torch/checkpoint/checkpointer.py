"""Atomic, resumable checkpoints (the port's copy of
``repro/checkpoint/checkpointer.py``).

Layout per step, as the reference writes it::

    <dir>/step_000000123/
        index.json      # leaves (key, shape, dtype) and the extra state
        shard_0.npz     # every leaf, by key
    <dir>/LATEST        # the newest step's directory name, written last

A save materialises every leaf on the host first (a consistent snapshot
of tensors the next step updates in place), writes a tmp directory,
renames it, then flips ``LATEST`` atomically; the writer may run on a
thread (``async_save``), and the oldest steps past ``keep`` are removed.
Restore takes the newest step whose index and shard verify, checks
every leaf's key, shape and dtype against the live tree and only then
copies into the live tensors in place; a step that fails a check is
skipped for an older one.

A tree is nested dicts of tensors (or numpy arrays); keys join with
``/``. A bf16 tensor is stored as its uint16 bits with dtype
``"bfloat16"`` in the index; an int8 :class:`~repro_torch.quant.QTensor`
leaf as ``<key>/q`` and ``<key>/scale``. The training tree is
``{"params": model.state_dict(), "opt": opt_state}``.
``restore_sharded`` places leaves on a mesh and waits for the planner
(ROADMAP A13).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.quant import is_qtensor


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in order; a QTensor gives ``key/q``, ``key/scale``."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += flatten(v, f"{prefix}{k}/")
        return out
    key = prefix[:-1]
    if is_qtensor(tree):
        return [(f"{key}/q", tree.q), (f"{key}/scale", tree.scale)]
    return [(key, tree)]


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def to_host(x) -> np.ndarray:
    """A leaf as the numpy array stored: a bf16 tensor as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)  # a snapshot, never a view
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.array(x)


def from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------ save ------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             host_index: int = 0, block: bool = False) -> None:
        self.wait()  # one writer at a time: a blocking save of the same
        # step as a pending async one would share its tmp directory
        leaves = [(k, dtype_name(v), to_host(v)) for k, v in flatten(tree)]

        def write():
            tmp = self.dir / f".tmp_step_{step:09d}_{host_index}"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / f"shard_{host_index}.npz",
                     **{k: v for k, _, v in leaves})
            index = {
                "step": step,
                "leaves": [{"key": k, "shape": list(v.shape), "dtype": dt}
                           for k, dt, v in leaves],
                "extra": extra or {},
            }
            (tmp / "index.json").write_text(json.dumps(index))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            latest_tmp = self.dir / ".LATEST.tmp"
            latest_tmp.write_text(final.name)
            latest_tmp.rename(self.dir / "LATEST")  # atomic pointer flip
            self._gc()

        if self.async_save and not block:
            def write_async():
                try:
                    write()
                except Exception as e:  # raised by the next wait()
                    self._error = e
            self._thread = threading.Thread(target=write_async, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the pending async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(old, ignore_errors=True)

    # ----------------------------- restore ----------------------------
    def available_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def _verify(self, path: pathlib.Path, host_index: int) -> bool:
        try:
            idx = json.loads((path / "index.json").read_text())
            with np.load(path / f"shard_{host_index}.npz") as z:
                names = set(z.files)
            return all(leaf["key"] in names for leaf in idx["leaves"])
        except Exception:
            return False

    def restore(self, like: Any, step: Optional[int] = None,
                host_index: int = 0) -> Tuple[Optional[Any], Optional[dict],
                                              int]:
        """Copy the newest verifiable checkpoint (<= ``step`` if given)
        into the tensors of ``like`` in place, after checking every
        leaf's key, shape and dtype. Returns (like | None, extra | None,
        restored step | -1)."""
        self.wait()
        candidates = [s for s in self.available_steps()
                      if step is None or s <= step]
        for s in reversed(candidates):
            path = self.dir / f"step_{s:09d}"
            if not self._verify(path, host_index):
                continue
            idx = json.loads((path / "index.json").read_text())
            dtypes = {leaf["key"]: leaf["dtype"] for leaf in idx["leaves"]}
            with np.load(path / f"shard_{host_index}.npz") as z:
                data = {k: z[k] for k in z.files}
            pairs = []
            for key, live in flatten(like):
                arr = data.get(key)
                if arr is None or dtypes.get(key) != dtype_name(live) \
                        or tuple(arr.shape) != tuple(live.shape):
                    pairs = None
                    break
                pairs.append((live, from_host(arr, dtypes[key])))
            if pairs is None:
                continue
            with torch.no_grad():
                for live, saved in pairs:
                    live.copy_(saved.to(live.device))
            return like, idx.get("extra", {}), s
        return None, None, -1
