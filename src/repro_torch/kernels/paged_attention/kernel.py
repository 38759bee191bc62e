"""Build and launch of the paged decode attention kernel for Hopper.

The CUDA source is ``repro_torch/csrc/paged_attention.cu`` (its header says
which TPU kernel it replaces, what bounds it and how the design answers
that).  It has a plain C interface: at first use ``nvcc`` compiles it for
``sm_90a`` into ``build/repro_torch/`` at the root of the checkout, under a
name keyed by a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is reused.  The library is loaded with
``ctypes``; tensors pass as raw pointers and the launch goes on PyTorch's
current stream.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

MAX_N = 256     # head dims the kernel takes (8 elements per lane)
MAX_G = 8       # query heads per KV head (kMaxG in the source)

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCE = _PKG / "csrc" / "paged_attention.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_fn: Optional[ctypes._CFuncPtr] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the paged-"
                           "attention kernel is built from source at first "
                           "use")
    return found


def build() -> Tuple[Path, str]:
    """Compile the source if no library for this exact source exists yet.
    Returns the library path and the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills; empty when the library was reused)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"paged_attention_{key}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".paged_attention_{key}.{os.getpid()}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)                 # atomic: concurrent builders agree
    return lib, proc.stderr


def _entry() -> ctypes._CFuncPtr:
    global _fn
    with _lock:
        if _fn is None:
            path, _ = build()
            fn = ctypes.CDLL(str(path)).repro_paged_attention
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def paged_attention_cuda(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                         table: torch.Tensor, lengths: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take (device, dtype, layout, shape).  Returns (B, J, G, N) in q's
    dtype, allocated here with ``torch.empty``."""
    tensors = {"q": q, "kp": kp, "vp": vp, "table": table,
               "lengths": lengths}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"expected q's CUDA device {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} {tuple(t.shape)} is "
                             "not contiguous")
    if q.dtype not in _DTYPE_CODE or kp.dtype != q.dtype \
            or vp.dtype != q.dtype:
        raise ValueError(f"paged_attention: q {q.dtype}, kp {kp.dtype}, vp "
                         f"{vp.dtype}; expected one of f32/bf16 throughout")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"paged_attention: table {table.dtype} and lengths "
                         f"{lengths.dtype} must be int32")
    if q.ndim != 4 or kp.ndim != 4 or vp.shape != kp.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, kp "
                         f"{tuple(kp.shape)}, vp {tuple(vp.shape)}")
    B, J, G, N = q.shape
    _, page, Jk, Nk = kp.shape
    if (Jk, Nk) != (J, N) or table.ndim != 2 or table.shape[0] != B \
            or tuple(lengths.shape) != (B,) or N > MAX_N or G > MAX_G:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)}, pool {tuple(kp.shape)}, "
            f"table {tuple(table.shape)}, lengths {tuple(lengths.shape)}")
    M = table.shape[1]
    out = torch.empty_like(q)
    fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), kp.data_ptr(),
                vp.data_ptr(), table.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, J, G, N, page, M, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out
