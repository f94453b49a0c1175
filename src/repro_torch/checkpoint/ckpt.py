"""Atomic checkpointing in the reference's on-disk layout — async by
default.

Counterpart of ``repro.checkpoint.ckpt``; each package restores what the
other saved. Layout::

    <dir>/step_<N>/host_<i>.npz  +  <dir>/step_<N>/manifest.json

* Leaves are named by their ``jax.tree_util.keystr`` path
  (``['opt']['m']['blocks']['attn']['wq']``, :mod:`repro_torch.tree`); a
  shard entry is ``key||<shard>||<start,...>``, the start being the shard's
  global index (``key||0||0,0`` for a whole 2-D leaf, ``key||0||`` for a
  scalar). A process writes its copy of a plain leaf whole, and its local
  shard of a ``DTensor`` leaf (a sharded train state) at the shard's global
  start, where it is the replica at coordinate 0 of every mesh dim the leaf
  is replicated over (so no shard is written twice). The manifest holds
  each leaf's whole shape. bf16 leaves are stored as their ``uint16`` bits
  with ``"bf16": true`` in the manifest; dtypes are numpy's names.
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
  leaves' devices, numpy leaves (the state's ``rng`` words) as numpy. It is
  **elastic**: with ``shardings=`` (a tree of ``NamedSharding``s on the
  target's structure), or for a ``DTensor`` target leaf under its own
  placements, a process reads only the shards that overlap its slice of
  the leaf and returns it as a ``DTensor``, whatever the world size and
  mesh shape that wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.device import process
from repro_torch.obs import profiling as _prof
from repro_torch.obs import runtime as _obs
from repro_torch.parallel import sharded_state as shst
from repro_torch.parallel.sharding import NamedSharding, is_dtensor, spec_of


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


def _writes(leaf) -> bool:
    """Whether this process writes its shard of a ``DTensor``: it is the
    replica at coordinate 0 of every mesh dim the leaf is replicated over."""
    spec = spec_of(leaf)
    used = {a for e in spec for a in ((e,) if isinstance(e, str)
                                      else (e or ()))}
    coord = leaf.device_mesh.get_coordinate()
    return all(c == 0 for name, c in zip(leaf.device_mesh.mesh_dim_names,
                                         coord) if name not in used)


def _snapshot(tree):
    """Copy this process's shards of ``tree`` to host memory (the sync
    phase): each plain leaf whole, each ``DTensor`` leaf's local shard at
    its global start where this process writes it (:func:`_writes`)."""
    shards: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for key, leaf in tree_mod.items(tree):
        start = None
        if is_dtensor(leaf):
            shard = leaf.to_local()
            idx = shst.local_index(leaf.shape, spec_of(leaf),
                                   leaf.device_mesh)
            if _writes(leaf):
                start = [s.start for s in idx]
            else:   # the dtype's names alone: an empty slice's copy
                shard = shard.reshape(-1)[:0]
            arr, dtype, bf16 = _host_copy(shard)
            meta[key] = {"shape": list(leaf.shape), "dtype": dtype,
                         "bf16": bf16}
        else:
            arr, dtype, bf16 = _host_copy(leaf)
            meta[key] = {"shape": list(arr.shape), "dtype": dtype,
                         "bf16": bf16}
            start = [0] * arr.ndim
        if start is not None:
            shards[f"{key}||0||{','.join(map(str, start))}"] = arr
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


def _shard_index(path: str) -> dict[str, list]:
    """leaf key -> [(file, member key, start, shape)] of every shard in the
    step's host files, read from the members' headers (no data)."""
    out: dict[str, list] = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".npz"):
            continue
        full = os.path.join(path, fname)
        with zipfile.ZipFile(full) as zf:
            for member in zf.namelist():
                with zf.open(member) as f:
                    version = np.lib.format.read_magic(f)
                    read = (np.lib.format.read_array_header_1_0
                            if version == (1, 0)
                            else np.lib.format.read_array_header_2_0)
                    shape = read(f)[0]
                skey = member[:-4] if member.endswith(".npy") else member
                key, _, start_s = skey.split("||")
                start = [int(x) for x in start_s.split(",")] \
                    if start_s else []
                out.setdefault(key, []).append((full, skey, start, shape))
    return out


def _assemble(key: str, info: dict, shards: list, region: tuple,
              files: dict) -> np.ndarray:
    """The ``region`` (a slice a dim) of leaf ``key`` from the shards that
    overlap it."""
    dt = np.uint16 if info.get("bf16") else np.dtype(info["dtype"])
    shape = tuple(r.stop - r.start for r in region)
    out = np.zeros(shape, dt)
    for fname, skey, start, sshape in shards:
        lo = [max(r.start, st) for r, st in zip(region, start)]
        hi = [min(r.stop, st + n) for r, st, n in zip(region, start, sshape)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        if fname not in files:
            files[fname] = np.load(fname)
        data = files[fname][skey]
        src = tuple(slice(a - st, b - st) for a, b, st in zip(lo, hi, start))
        dst = tuple(slice(a - r.start, b - r.start)
                    for a, b, r in zip(lo, hi, region))
        out[dst if dst else ...] = data[src if src else ...]
    return out


def _placed(arr: np.ndarray, bf16: bool, target):
    """A restored array in the kind of its ``target`` leaf: a tensor on the
    target's device (bf16 from its bits), or a numpy array."""
    if not isinstance(target, torch.Tensor):
        return arr
    if bf16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(shst.local(target).device)


def restore(directory: str, step: int, target_tree, shardings=None):
    """Rebuild a ``target_tree``-shaped tree from the checkpoint: each leaf
    with the saved dtype and values, placed as the target's leaf is (a
    tensor on its device, or a numpy array).

    ``shardings`` (a tree of ``NamedSharding``s on the target's structure,
    the reference's argument) places each leaf as a ``DTensor`` whose local
    shard is this process's slice under its spec; without it a ``DTensor``
    target leaf keeps its own placements and any other leaf is whole. Only
    the shards overlapping a process's slice are read."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    index = _shard_index(path)
    placed = (tree_mod.map_tree(lambda _, s: s, target_tree, shardings)
              if shardings is not None else None)
    wanted = (tree_mod.leaves(placed) if placed is not None
              else [None] * len(tree_mod.leaves(target_tree)))
    files: dict = {}
    out = []
    try:
        for (key, leaf), sharding in zip(tree_mod.items(target_tree),
                                         wanted):
            info = manifest["leaves"][key]
            shape = tuple(info["shape"])
            if not isinstance(leaf, torch.Tensor):
                sharding = None             # numpy leaves stay whole
            elif sharding is None and is_dtensor(leaf):
                sharding = NamedSharding(leaf.device_mesh, spec_of(leaf))
            region = (shst.local_index(shape, sharding.spec, sharding.mesh)
                      if sharding is not None
                      else tuple(slice(0, n) for n in shape))
            arr = _placed(_assemble(key, info, index.get(key, []), region,
                                    files), info.get("bf16", False), leaf)
            out.append(shst.dtensor(arr, sharding, shape)
                       if sharding is not None else arr)
    finally:
        for z in files.values():
            z.close()
    return tree_mod.unflatten(target_tree, out)
