"""Build and load the CUDA kernels of ``csrc/``.

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links them into one shared
library with a plain C interface under ``build/`` at the root of the
checkout. The library's directory is named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. It is loaded with ``ctypes``; the wrappers in ``kernels/ops.py`` pass
pointers and the stream as ``c_void_p``.

Nothing here runs when the module is imported: the CPU tests import every
module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
SIGNATURES = {
    "tcu_reduce_launch": (_P, _P, _P) + (_LL,) * 4 + (_I,) * 3 + (_P,),
    "tcu_scan_launch": (_P, _P, _P) + (_LL,) * 4 + (_I,) * 3 + (_P,),
    "ssd_scan_launch": (_P,) * 7 + (_I,) * 8 + (_LL,) * 15 + (_P,),
    "weighted_scan_launch": (_P,) * 4 + (_LL,) * 4 + (_I,) * 4 + (_P,),
    "rmsnorm_launch": (_P, _P, _P, _LL, _I, _I, _I, ctypes.c_float, _I, _P),
    "flash_attention_launch": (_P,) * 4 + (_I,) * 9 + (ctypes.c_float,)
                              + (_LL,) * 9 + (_P,),
    "matmul_local_scan_launch": (_P, _P, _LL, _LL, _I, _I, _P),
    "matmul_local_weighted_launch": (_P, _P, _P, _LL, _LL, _I, _P),
    "matmul_local_ssd_launch": (_P,) * 7 + (_I,) * 8 + (_LL,) * 15 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the build this process ran


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH):"
                           " the Hopper kernels are built at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    """One nvcc per source, all in parallel, then one link."""
    nvcc = nvcc_path()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    lib = out_dir / "librepro_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(lib), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "librepro_kernels.so"


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this checkout."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            t0 = time.perf_counter()
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
            try:
                _compile(tmp)
                try:
                    tmp.rename(path.parent)
                except OSError:     # another process finished first
                    if not path.exists():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        for name in ("ssd_scan_smem_bytes", "matmul_local_ssd_smem_bytes"):
            fn = getattr(lib, name)
            fn.argtypes = [_I, _I, _I]
            fn.restype = _LL
        lib.ssd_uses_mma.argtypes = [_I, _I, _I, _I]
        lib.ssd_uses_mma.restype = _I
        lib.flash_attention_smem_bytes.argtypes = [_I, _I, _I]
        lib.flash_attention_smem_bytes.restype = _LL
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        text = _lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {text}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
