"""Device selection and the Hopper capability probe.

Counterpart of the probes in ``repro.kernels.backend``. There is no Pallas
here: a kernel of this package is CUDA C++ built for ``sm_90a`` and runs on a
compute-capability 9.0 card or not at all.
"""
from __future__ import annotations

import functools

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless asked."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def require_hopper(device: torch.device | None = None) -> None:
    """Raise unless ``device`` is a CUDA card of compute capability 9.0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the Hopper kernels need an H100 "
                           "(pass CPU tensors to run the plain versions)")
    index = 0 if device is None or device.index is None else device.index
    cap = _capability(index)
    if cap != (9, 0):
        raise RuntimeError(
            f"kernels are built for sm_90a; cuda:{index} has compute "
            f"capability {cap[0]}.{cap[1]}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels' launch plans
    take it)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
