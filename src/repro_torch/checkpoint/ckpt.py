"""Atomic checkpointing in the reference's on-disk layout — async by
default.

Counterpart of ``repro.checkpoint.ckpt``; each package restores what the
other saved. Layout::

    <dir>/step_<N>/host_<i>.npz  +  <dir>/step_<N>/manifest.json

* Leaves are named by their ``jax.tree_util.keystr`` path
  (``['opt']['m']['blocks']['attn']['wq']``, :mod:`repro_torch.tree`); a
  shard entry is ``key||<shard>||<start,...>`` (``key||0||0,0`` for a whole
  2-D leaf, ``key||0||`` for a scalar). A process writes its copy of every
  leaf as shard 0. bf16 leaves are stored as their ``uint16`` bits with
  ``"bf16": true`` in the manifest; dtypes are numpy's names.
* **Async save** (:class:`AsyncCheckpointer`): ``save()`` copies the tree
  to host memory (so later steps cannot change what is written) and
  returns; write + fsync + rename run on a background thread. The *next*
  ``save()`` (or an explicit :meth:`~AsyncCheckpointer.wait`) is the
  barrier: it joins the previous write and re-raises any I/O error.
* Commit is atomic: write into ``step_<N>.tmp``, fsync, rename. A crash
  mid-write never corrupts the latest valid checkpoint; ``latest_step``
  ignores ``.tmp`` dirs, and the next save sweeps stale ``.tmp`` dirs a
  crash left behind. **Multi-process commit**: every process
  (``torch.distributed`` rank) writes ``host_<i>.npz`` into the shared tmp
  dir (via a ``.part`` rename so a half-written file is never counted);
  process 0 renames to the final name only once all of them exist, and the
  others block until the rename lands.
* Restore rebuilds the target tree from the shards: tensors on the target
  leaves' devices, numpy leaves (the state's ``rng`` words) as numpy.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.device import process
from repro_torch.obs import profiling as _prof
from repro_torch.obs import runtime as _obs


def _host_copy(leaf) -> tuple[np.ndarray, str, bool]:
    """(a host copy of ``leaf``, its numpy dtype name, whether it is bf16
    stored as uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16", \
                True
        arr = t.numpy()
    else:
        arr = np.array(leaf)    # copy
    return arr, str(arr.dtype), False


def _snapshot(tree):
    """Copy every leaf of ``tree`` to host memory (the sync phase)."""
    shards: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for key, leaf in tree_mod.items(tree):
        arr, dtype, bf16 = _host_copy(leaf)
        meta[key] = {"shape": list(arr.shape), "dtype": dtype, "bf16": bf16}
        start = ",".join(["0"] * arr.ndim)
        shards[f"{key}||0||{start}"] = arr
    return shards, meta


def _sweep_stale_tmp(directory: str, current_step: int) -> None:
    """Remove ``step_*.tmp`` dirs a crashed run left behind (never the
    current step's: in a multi-process save other processes may be writing
    it)."""
    if not os.path.isdir(directory):
        return
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)\.tmp", d)
        if m and int(m.group(1)) != current_step:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for d in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", d))
        and os.path.exists(os.path.join(directory, d, "manifest.json")))


class AsyncCheckpointer:
    """Overlap checkpoint I/O with the step loop; at most one in flight.

    ``save(step, tree)`` returns after the host-memory snapshot;
    ``wait()`` blocks until the write is committed (and re-raises any
    background error). Calling ``save`` again waits for the previous write
    first — that is the barrier contract the training loop relies on.

    ``keep_last=N`` garbage-collects older committed ``step_*`` dirs after
    each commit (process 0 only); None keeps everything.
    """

    def __init__(self, directory: str, *, keep_last: int | None = None,
                 poll_s: float = 0.05, timeout_s: float = 600.0,
                 _pre_commit=None):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = str(directory)
        self.keep_last = keep_last
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self._pre_commit = _pre_commit  # test hook: runs before commit
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._committed: str | None = None

    def save(self, step: int, tree) -> None:
        """Snapshot ``tree`` and schedule the write; returns immediately.

        Blocks only on the *previous* save's completion (the barrier) and
        on the device->host copy of the tree.
        """
        self.wait()
        _sweep_stale_tmp(self.directory, step)
        # the session is captured HERE and handed to the writer thread:
        # the background write must land in the session that was active
        # when the save was issued, even if the scope closes meanwhile
        sess = _obs.ACTIVE
        t_snap = time.perf_counter() if sess is not None else 0.0
        with _prof.span("ckpt/snapshot"):
            shards, meta = _snapshot(tree)
        if sess is not None:
            dur = time.perf_counter() - t_snap
            sess.histogram(
                "repro_ckpt_snapshot_seconds",
                "device->host shard snapshot (blocks the step loop)"
            ).observe(dur)
            sess.emit("ckpt", phase="snapshot", step=int(step), seconds=dur)
        host, n_hosts = process()
        self._thread = threading.Thread(
            target=self._write, name=f"ckpt-step{step}",
            args=(step, shards, meta, host, n_hosts, sess), daemon=True)
        self._thread.start()

    def wait(self) -> str | None:
        """Block until the in-flight save (if any) is committed; returns
        the last committed path. Re-raises a background write error."""
        t, self._thread = self._thread, None
        if t is not None:
            sess = _obs.ACTIVE
            if sess is not None:
                t_join = time.perf_counter()
                t.join()
                dur = time.perf_counter() - t_join
                sess.histogram(
                    "repro_ckpt_commit_barrier_seconds",
                    "time the step loop blocked joining the in-flight "
                    "checkpoint write").observe(dur)
                sess.emit("ckpt", phase="commit_barrier", seconds=dur)
            else:
                t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._committed

    def last_committed(self) -> str | None:
        """The last committed path (does not block; None if the first save
        is still in flight or never happened)."""
        return self._committed

    # -- background phase ---------------------------------------------------

    def _write(self, step, shards, meta, host, n_hosts, sess=None):
        t_w = time.perf_counter()
        try:
            self._committed = self._write_inner(
                step, shards, meta, host, n_hosts)
        except BaseException as e:  # surfaced by the next wait()/save()
            self._error = e
            return
        if sess is not None:   # the session captured at save() time —
            # this thread records into it even after the scope moved on
            dur = time.perf_counter() - t_w
            sess.histogram(
                "repro_ckpt_write_seconds",
                "background write+fsync+commit duration").observe(dur)
            sess.emit("ckpt", phase="write", step=int(step), seconds=dur)

    def _write_inner(self, step, shards, meta, host, n_hosts) -> str:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)

        # never let a half-written npz count toward the commit quorum
        part = os.path.join(tmp, f"host_{host}.npz.part")
        with open(part, "wb") as f:  # np.savez would append ".npz" to a path
            np.savez(f, **shards)
        os.replace(part, os.path.join(tmp, f"host_{host}.npz"))
        if host == 0:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": meta,
                           "n_hosts": n_hosts}, f)
        if self._pre_commit is not None:
            self._pre_commit()

        deadline = time.monotonic() + self.timeout_s
        if host == 0:
            # commit only once every process's shards are on disk
            while True:
                have = sum(
                    os.path.exists(os.path.join(tmp, f"host_{i}.npz"))
                    for i in range(n_hosts))
                if have == n_hosts:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"checkpoint step {step}: only {have}/{n_hosts} "
                        f"host files after {self.timeout_s}s")
                time.sleep(self.poll_s)
            fd = os.open(tmp, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
            if os.path.exists(final):  # re-save of an existing step
                shutil.rmtree(final)
            os.replace(tmp, final)
            if self.keep_last is not None:
                for old in _committed_steps(self.directory)[:-self.keep_last]:
                    shutil.rmtree(
                        os.path.join(self.directory, f"step_{old}"),
                        ignore_errors=True)
        else:
            # the rename is process 0's; block until it lands
            while os.path.exists(tmp) or not os.path.exists(
                    os.path.join(final, "manifest.json")):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"checkpoint step {step}: process 0 did not commit "
                        f"within {self.timeout_s}s")
                time.sleep(self.poll_s)
        return final


def save(directory: str, step: int, tree, *,
         keep_last: int | None = None) -> str:
    """Synchronous save (write + commit before returning); returns the
    committed path. The async form is :class:`AsyncCheckpointer`."""
    ckpt = AsyncCheckpointer(directory, keep_last=keep_last)
    ckpt.save(step, tree)
    return ckpt.wait()


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _placed(arr: np.ndarray, bf16: bool, target):
    """A restored array in the kind of its ``target`` leaf: a tensor on the
    target's device (bf16 from its bits), or a numpy array."""
    if not isinstance(target, torch.Tensor):
        return arr
    if bf16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(target.device)


def restore(directory: str, step: int, target_tree):
    """Rebuild a ``target_tree``-shaped tree from the checkpoint: each leaf
    with the saved dtype and values, placed as the target's leaf is (a
    tensor on its device, or a numpy array)."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    # gather shards from every host file present
    assembled: dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".npz"):
            continue
        with np.load(os.path.join(path, fname)) as z:
            for skey in z.files:
                key, _, start_s = skey.split("||")
                info = manifest["leaves"][key]
                if key not in assembled:
                    dt = np.uint16 if info.get("bf16") else np.dtype(
                        info["dtype"])
                    assembled[key] = np.zeros(info["shape"], dt)
                data = z[skey]
                start = ([int(x) for x in start_s.split(",")]
                         if start_s else [])
                idx = tuple(slice(st, st + sh)
                            for st, sh in zip(start, data.shape))
                assembled[key][idx if idx else ...] = data

    out = [_placed(assembled[key], manifest["leaves"][key].get("bf16",
                                                                False), leaf)
           for key, leaf in tree_mod.items(target_tree)]
    return tree_mod.unflatten(target_tree, out)
