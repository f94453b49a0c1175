"""Deterministic synthetic LM data pipeline, host-sharded.

Counterpart of ``repro.data.pipeline``. Determinism is the fault-tolerance
contract: batch contents are a pure function of (seed, step, global example
index), so a host that is replaced mid-run regenerates exactly its shard,
with no data-order drift on restart and no shuffle buffer to checkpoint.
The tokens come from numpy's Philox as in the reference, bit for bit. Each
host materialises only its slice of the global batch: by
``torch.distributed`` rank and world size ((0, 1) without it), or, given a
mesh (``sharding=``, a ``DeviceMesh`` or a ``MeshContext``), by the rank's
coordinate on the mesh's ``data`` dim, so that the ranks of one data
coordinate (a ``model`` group) get the same rows. A prefetch thread builds
the next batches in pinned host memory; the consuming thread moves each to
the device without blocking the host.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch import device as devmod


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefetch: int = 2


def _philox_tokens(cfg: DataConfig, step: int, lo: int, hi: int) -> np.ndarray:
    """Tokens for global examples [lo, hi) at ``step`` — pure function."""
    rng = np.random.Generator(np.random.Philox(
        key=cfg.seed, counter=[0, 0, step, 0]))
    # skip-ahead is per-example so hosts draw disjoint, stable streams
    all_tok = rng.integers(1, cfg.vocab, size=(cfg.global_batch,
                                               cfg.seq_len + 1),
                           dtype=np.int32)
    return all_tok[lo:hi]


class SyntheticLMPipeline:
    """Iterator of ``(step, {"tokens", "labels"})`` device batches; int32
    tokens, as the reference's."""

    def __init__(self, cfg: DataConfig, *, device=None, sharding=None):
        self.cfg = cfg
        self.device = devmod.resolve(device)
        # a MeshContext carries its DeviceMesh (None: topology-only)
        self.sharding = getattr(sharding, "mesh", sharding)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._step = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def host_range(self, process_index: int | None = None,
                   process_count: int | None = None) -> tuple[int, int]:
        """This host's [lo, hi) slice of the global batch.

        Remainder-aware: when ``global_batch`` is not divisible by the
        process count, the first ``global_batch % process_count`` hosts
        take one extra example, so the host slices exactly cover
        ``[0, global_batch)`` — disjoint, no example dropped or doubled.
        Pass explicit ``process_index``/``process_count`` to inspect
        another host's slice (tests simulate whole topologies this way).
        Under a mesh the "hosts" are the ``data`` dim's coordinates (one
        slice for a mesh without that dim).
        """
        idx, n_proc = self._data_coordinate()
        n_proc = n_proc if process_count is None else process_count
        idx = idx if process_index is None else process_index
        base, rem = divmod(self.cfg.global_batch, n_proc)
        lo = idx * base + min(idx, rem)
        return lo, lo + base + (1 if idx < rem else 0)

    def _data_coordinate(self) -> tuple[int, int]:
        mesh = self.sharding
        if mesh is None:
            return devmod.process()
        names = tuple(mesh.mesh_dim_names)
        if "data" not in names:
            return 0, 1
        i = names.index("data")
        return mesh.get_coordinate()[i], mesh.size(i)

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        lo, hi = self.host_range()
        tok = _philox_tokens(self.cfg, step, lo, hi)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def _host_tensors(self, step: int) -> dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in self.host_batch(step).items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _to_device(self, host: dict) -> dict[str, torch.Tensor]:
        return {k: v.to(self.device, non_blocking=True)
                for k, v in host.items()}

    def device_batch(self, step: int) -> dict[str, torch.Tensor]:
        return self._to_device(self._host_tensors(step))

    def __iter__(self):
        def worker():
            s = self._step
            while not self._stop.is_set():
                item = (s, self._host_tensors(s))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        if self._thread is None:
            self._thread = threading.Thread(target=worker, daemon=True)
            self._thread.start()
        while True:
            s, host = self._q.get()
            yield s, self._to_device(host)

    def close(self) -> None:
        """Stop the prefetch thread (if iteration started it)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def skip_to(self, step: int) -> None:
        """Resume support: restart generation at ``step`` (pure function of
        step, so this is just a counter)."""
        if self._thread is not None:
            raise RuntimeError("skip_to must be called before iteration")
        self._step = step
