"""Build the CUDA kernels from ``csrc/`` on first use and bind them.

Every ``csrc/*.cu`` exports plain C functions (pointers, ints, a stream)
that launch one kernel and return ``cudaGetLastError()``.  On first use all
sources are compiled together, one ``nvcc -shared`` process per source
started at once, for ``sm_90a``; each shared library is loaded with
``ctypes``.  Binding through a plain C interface keeps PyTorch's headers
out of the build, which is what makes it take seconds, not minutes.

The libraries go to ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of their source and flags, so a
changed source is rebuilt and an unchanged one is reused.  A failed build
raises: there is no fallback to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LIBS: dict = {}          # source stem -> ctypes.CDLL (one load per process)
_FUNCS: dict = {}         # (stem, symbol) -> bound C entry point
BUILD_LOG: dict = {}      # source stem -> compiler output (ptxas register use)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit was not found (CUDA_HOME unset "
                           "and no nvcc on PATH): cannot build the kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every ``csrc/*.cu`` not yet built, all in parallel, and load
    them.  -> seconds spent (0.0 when everything was already loaded)."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [s for s in sources if s.stem not in _LIBS]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in todo:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (out, tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\n[timed out after {BUILD_TIMEOUT_S} s]"
        BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for src in todo:
        _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
    return time.perf_counter() - t0


def kernel_function(stem: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<stem>.cu``, built on first use,
    returning an int CUDA error code."""
    fn = _FUNCS.get((stem, symbol))
    if fn is None:
        if stem not in _LIBS:
            build_all()
        fn = getattr(_LIBS[stem], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(stem, symbol)] = fn
    return fn


def check_launch(rc: int, name: str):
    """Raise when a launch was refused (``cudaGetLastError`` != 0)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error "
                           f"code {rc}")


def check_cuda_tensor(t, name: str, ndim: int, dtypes):
    """The checks every wrapper makes before handing a pointer to a kernel."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device "
                         f"{t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def dtype_code(dtype) -> int:
    """The kernels' dtype switch: 0 = float32, 1 = bfloat16."""
    return {torch.float32: 0, torch.bfloat16: 1}[dtype]


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
