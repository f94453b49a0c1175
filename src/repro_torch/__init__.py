"""PyTorch port of ``repro``: the paper's matmul-form reduce and scan, their
weighted-scan and Mamba-2 SSD generalisations, and a served model, with the
TPU kernels rewritten by hand in CUDA C++ for Hopper (``sm_90a``).

The package imports ``torch`` and never ``jax`` or ``repro``. Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version instead of the kernel.
"""
