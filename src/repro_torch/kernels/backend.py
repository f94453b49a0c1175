"""Capability probes of the kernel-selection layer.

Counterpart of the probes in ``repro.kernels.backend``. The reference asks
the process (``jax.default_backend()``); the port asks the tensor of the
call, so that one process may hold CPU and CUDA tensors and each call
resolves for the device its data lies on. There is no registry here:
``repro_torch.core.dispatch`` calls the wrappers of
``repro_torch.kernels.ops`` directly and hands them the
:class:`~repro_torch.core.policy.TuneSpec` that resolution chose.
"""
from __future__ import annotations

import torch

from repro_torch import device as devmod


def on_tpu() -> bool:
    """Always False: the port has no TPU route."""
    return False


def on_gpu(device=None) -> bool:
    """True when ``device`` (None: the process's default) is a CUDA card."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def native_tile_backend(device=None) -> str | None:
    """``"tile_gpu"`` for a CUDA device of compute capability 9.0 (what the
    kernels of ``csrc/`` are built for, as ``device.require_hopper``
    checks), else None: nothing to launch a kernel on."""
    if not on_gpu(device) or not torch.cuda.is_available():
        return None
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return "tile_gpu" if devmod._capability(index) == (9, 0) else None
