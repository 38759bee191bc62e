"""Build and launch of the paged decode attention kernels for Hopper.

Two CUDA sources under ``repro_torch/csrc/``, each a plain C interface
whose header says which TPU kernel it replaces, what bounds it and how the
design answers that:

  * ``paged_attention.cu`` — K1, pools in q's dtype (f32 or bf16);
  * ``paged_attention_quant.cu`` — K2, int8 pools with f32 scales.

At first use ``nvcc`` compiles each for ``sm_90a`` into ``build/repro_torch/``
at the root of the checkout, under a name keyed by a hash of the source and
flags, so an edited source is rebuilt and an unchanged one is reused;
``build()`` starts one ``nvcc`` per missing library, all at once.  The
libraries are loaded with ``ctypes``; tensors pass as raw pointers and each
launch goes on PyTorch's current stream.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

MAX_N = 256     # head dims the kernels take (8 elements per lane)
MAX_G = 8       # query heads per KV head (kMaxG in the sources)

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = {
    "paged_attention": _PKG / "csrc" / "paged_attention.cu",
    "paged_attention_quant": _PKG / "csrc" / "paged_attention_quant.cu",
}
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# C entry point and argument list of each library: the dtype code, the
# tensor pointers, the int sizes (B, J, G, N, page, M), the stream.
_ENTRY = {
    "paged_attention": ("repro_paged_attention", 6),
    "paged_attention_quant": ("repro_paged_attention_quant", 8),
}

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the paged-"
                           "attention kernels are built from source at "
                           "first use")
    return found


def _lib_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def build(*names: str) -> Dict[str, Tuple[Path, str]]:
    """Compile the named kernels (all of them by default) whose library
    for this exact source does not exist yet, one ``nvcc`` each, run
    together.  Returns ``{name: (library path, compiler report)}``; the
    report (``-Xptxas -v``: registers, shared memory, spills) is empty for
    a library that was reused."""
    names = names or tuple(SOURCES)
    out: Dict[str, Tuple[Path, str]] = {}
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{lib.stem}.{os.getpid()}.so"
        procs[name] = (lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]} "
                          f"({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib)             # atomic: concurrent builders agree
        out[name] = (lib, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _entry(name: str) -> ctypes._CFuncPtr:
    with _lock:
        if name not in _fns:
            path, _ = build(name)[name]
            symbol, n_ptrs = _ENTRY[name]
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def _check_cuda(kernel: str, tensors: Dict[str, torch.Tensor],
                device: torch.device) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"q's CUDA device {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} is not "
                             "contiguous")


def _launch(name: str, q: torch.Tensor, ptrs, sizes) -> torch.Tensor:
    out = torch.empty_like(q)
    fn = _entry(name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], *ptrs, out.data_ptr(), *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def paged_attention_cuda(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                         table: torch.Tensor, lengths: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take (device, dtype, layout, shape).  Returns (B, J, G, N) in q's
    dtype, allocated here with ``torch.empty``."""
    _check_cuda("paged_attention", {"q": q, "kp": kp, "vp": vp,
                                    "table": table, "lengths": lengths},
                q.device)
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
    return _launch("paged_attention", q,
                   (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    table.data_ptr(), lengths.data_ptr()),
                   (B, J, G, N, page, table.shape[1]))


def paged_attention_quant_cuda(q: torch.Tensor, kp: torch.Tensor,
                               vp: torch.Tensor, ksc: torch.Tensor,
                               vsc: torch.Tensor, table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Launch the int8-pool kernel on CUDA tensors; raises on anything it
    does not take (device, dtype, layout, shape).  Returns (B, J, G, N) in
    q's dtype, allocated here with ``torch.empty``."""
    _check_cuda("paged_attention_quant",
                {"q": q, "kp": kp, "vp": vp, "ksc": ksc, "vsc": vsc,
                 "table": table, "lengths": lengths}, q.device)
    if q.dtype not in _DTYPE_CODE or kp.dtype != torch.int8 \
            or vp.dtype != torch.int8 or ksc.dtype != torch.float32 \
            or vsc.dtype != torch.float32:
        raise ValueError(f"paged_attention_quant: q {q.dtype}, kp "
                         f"{kp.dtype}, vp {vp.dtype}, ksc {ksc.dtype}, vsc "
                         f"{vsc.dtype}; expected f32/bf16 q, int8 pools, "
                         "f32 scales")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"paged_attention_quant: table {table.dtype} and "
                         f"lengths {lengths.dtype} must be int32")
    if q.ndim != 4 or kp.ndim != 4 or vp.shape != kp.shape \
            or ksc.shape != kp.shape[:3] or vsc.shape != kp.shape[:3]:
        raise ValueError(
            f"paged_attention_quant: q {tuple(q.shape)}, kp "
            f"{tuple(kp.shape)}, vp {tuple(vp.shape)}, ksc "
            f"{tuple(ksc.shape)}, vsc {tuple(vsc.shape)}")
    B, J, G, N = q.shape
    _, page, Jk, Nk = kp.shape
    if (Jk, Nk) != (J, N) or table.ndim != 2 or table.shape[0] != B \
            or tuple(lengths.shape) != (B,) or N > MAX_N or G > MAX_G:
        raise ValueError(
            f"paged_attention_quant: q {tuple(q.shape)}, pool "
            f"{tuple(kp.shape)}, table {tuple(table.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    return _launch("paged_attention_quant", q,
                   (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    ksc.data_ptr(), vsc.data_ptr(), table.data_ptr(),
                    lengths.data_ptr()),
                   (B, J, G, N, page, table.shape[1]))
