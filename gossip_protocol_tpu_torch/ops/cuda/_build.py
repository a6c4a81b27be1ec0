"""Build and bind the port's CUDA kernels (nvcc + ctypes).

The sources under ``gossip_protocol_tpu_torch/csrc/`` have a plain C
interface and are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

into ``csrc/build/`` (ignored by git), one shared library per source,
defines and source hash, so an edited source rebuilds and an unchanged
one loads at once.  The sources compile in parallel, one nvcc each.
A source built with ``-D`` defines (a measurement variant, such as
``overlay_tick.cu``'s ``K5_VARIANT``) is a library of its own beside it.
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
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
#: each source is one library: its C entry points and their arguments
SOURCES = {
    "dense_tick.cu": {
        "gp_masked_max3": [_P] * 9 + [_I] * 6 + [_P],
        "gp_merge_scratch_words": [_I] * 2,
        "gp_tick_epilogue": [_P] * 21 + [_I] * 4 + [_P],
        "gp_dense_mega_ticks": [_P] * 15 + [_I] * 6 + [_P],
    },
    "drop.cu": {
        "gp_drop_masks": [_P] * 5 + [_U, _U, _I, _U, _U, ctypes.c_float]
                         + [_I] * 3 + [_P],
        "gp_drop_masks_lanes": [_P] * 9 + [_I] * 6 + [_P],
    },
    "overlay_tick.cu": {
        "gp_fused_overlay_tick": [_P] * 8 + [_I] * 6 + [_P],
        "gp_fused_overlay_tick_sharded": [_P] * 9 + [_I] * 7 + [_P],
        "gp_mega_overlay_ticks": [_P] * 5 + [_I] * 10 + [_P],
        "gp_grid_overlay_ticks": [_P, _L] + [_P] * 5 + [_I] * 13 + [_P],
        "gp_grid_boot": [_P, _L, _P, _P] + [_I] * 5 + [_P],
        "gp_grid_blocks_per_sm": [_I] * 2,
    },
}

_libs: dict = {}
#: guards the first load (and build) of a library and the launch counts:
#: the shards of a mesh (parallel/mesh.py) launch from their own threads
_LOCK = threading.RLock()


#: nvcc processes started so far (see :func:`nvcc_build_count`)
_NVCC_BUILDS = 0


def nvcc_build_count() -> int:
    """Number of nvcc compilations this process has started: zero once
    every library is built, so a warm lap that adds one rebuilt a
    kernel (analysis/guards.py)."""
    return _NVCC_BUILDS


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to a wrapper's launch count (``fn.launches``, or the
    count named ``attr``), safe from several threads at once."""
    with _LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def lib_path(source: str, defines: tuple = ()) -> Path:
    """Where the library of one source built with ``defines`` lives
    (named by its hash)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, variants: tuple = ()) -> list[Path]:
    """Compile every source, and each ``(source, defines)`` of
    ``variants``, whose hash has no library yet, one nvcc process each,
    all started together; returns the libraries' paths (the sources'
    first).  ``verbose`` prints the sources' ``-Xptxas -v`` reports."""
    global _NVCC_BUILDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(s, ()) for s in SOURCES] + [(s, tuple(d)) for s, d in variants]
    outs = [lib_path(s, d) for s, d in jobs]
    procs = []
    for (source, defines), out in zip(jobs, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines]
        if verbose and not defines:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / source)]
        procs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        with _LOCK:
            _NVCC_BUILDS += 1
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


def library(source: str = "dense_tick.cu",
            defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of one source (all are built at first use), or
    of its variant built with ``defines``."""
    key = source if not defines else (source, tuple(defines))
    if key in _libs:
        return _libs[key]
    with _LOCK:
        if key in _libs:
            return _libs[key]
        path = lib_path(source, defines)
        if not path.exists():
            build(variants=((source, defines),) if defines else ())
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SOURCES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gp_error_string.argtypes = [ctypes.c_int]
        lib.gp_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


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
