"""Build and bind the port's CUDA kernels (nvcc + ctypes).

The sources under ``gossip_protocol_tpu_torch/csrc/`` have a plain C
interface and are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

into ``csrc/build/`` (ignored by git), one shared library per source
hash, so an edited source rebuilds and an unchanged one loads at once.
Nothing here includes PyTorch's headers, so a build takes seconds.

Pointers cross as ``ctypes.c_void_p`` (``tensor.data_ptr()``), the
stream as ``torch.cuda.current_stream().cuda_stream``.  Every entry
point returns ``cudaGetLastError()`` after its launches; :func:`check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("dense_tick.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gp_masked_max3": [_P] * 8 + [_I] * 3 + [_P],
    "gp_tick_epilogue": [_P] * 21 + [_I] * 3 + [_P],
    "gp_dense_mega_ticks": [_P] * 15 + [_I] * 5 + [_P],
}

_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet;
    returns the library's path."""
    out = BUILD_DIR / f"libgossip_dense_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp)] + [str(CSRC / s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gp_error_string.argtypes = [ctypes.c_int]
        lib.gp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = library().gp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    """Device pointer of a tensor that :func:`check_args` accepted (None
    for None: a null pointer)."""
    return None if t is None else t.data_ptr()


def check_args(what: str, *specs) -> None:
    """Validate a launch's inputs before their pointers cross: each spec
    is ``(tensor, dtype, shape)``; all must be contiguous CUDA tensors
    on one device with exactly that dtype and shape."""
    dev = specs[0][0].device
    for t, dtype, shape in specs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected CUDA tensors on one device, "
                             f"got {t.device} beside {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: kernel inputs must be contiguous")
