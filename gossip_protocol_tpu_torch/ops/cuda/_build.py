"""Build and bind the port's CUDA kernels (nvcc + ctypes).

The sources under ``gossip_protocol_tpu_torch/csrc/`` have a plain C
interface and are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

into ``csrc/build/`` (ignored by git), one shared library per source
and source hash, so an edited source rebuilds and an unchanged one
loads at once.  The sources compile in parallel, one nvcc each.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: each source is one library: its C entry points and their arguments
SOURCES = {
    "dense_tick.cu": {
        "gp_masked_max3": [_P] * 9 + [_I] * 3 + [_P],
        "gp_merge_scratch_words": [_I],
        "gp_tick_epilogue": [_P] * 21 + [_I] * 3 + [_P],
        "gp_dense_mega_ticks": [_P] * 15 + [_I] * 5 + [_P],
    },
    "overlay_tick.cu": {
        "gp_fused_overlay_tick": [_P] * 8 + [_I] * 6 + [_P],
        "gp_mega_overlay_ticks": [_P] * 5 + [_I] * 9 + [_P],
        "gp_grid_overlay_ticks": [_P, _L] + [_P] * 5 + [_I] * 13 + [_P],
    },
}

_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def lib_path(source: str) -> Path:
    """Where the library of one source lives (named by its hash)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> list[Path]:
    """Compile every source whose hash has no library yet, one nvcc
    process per source, all started together; returns the libraries'
    paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [lib_path(s) for s in SOURCES]
    procs = []
    for source, out in zip(SOURCES, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / source)]
        procs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{out.name}: nvcc failed ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
            continue
        if verbose:
            print(stderr, end="")
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def library(source: str = "dense_tick.cu") -> ctypes.CDLL:
    """The loaded library of one source (all are built at first use)."""
    if source not in _libs:
        path = lib_path(source)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SOURCES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gp_error_string.argtypes = [ctypes.c_int]
        lib.gp_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return _libs[source]


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
