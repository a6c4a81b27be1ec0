"""ctypes bindings for the native runtime (libgossip_native.so); port copy
of ``gossip_protocol_tpu/compat/native.py``.

The native layer (``native/``) is the framework's C++ runtime: the
EmulNet-shaped message bus (bus.cc — ENinit/ENsend/ENrecv/ENcleanup
semantics, reference EmulNet.h:92-96), the reference-grammar log sink
(logsink.cc) and the struct-of-arrays protocol engine (engine.cc) that
serves as the CPU-native backend and differential oracle for the JAX
engine.  Build it with ``make`` at the repo root; these bindings load the
shared library and expose the C ABI to Python for tests and tooling.

The native engine is neither the JAX package nor this one, so it is an
independent check of the port wherever g++ builds it.  :func:`load`
returns None when the library cannot be built (the tests skip then);
:func:`require` builds it with make and raises instead, for callers that
must not skip silently (``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB_NAME = "libgossip_native.so"


def lib_path() -> str:
    return os.path.join(_REPO_ROOT, LIB_NAME)


def build(quiet: bool = True) -> bool:
    """Build the native runtime via make.  Returns True on success."""
    try:
        res = subprocess.run(["make", LIB_NAME], cwd=_REPO_ROOT,
                             capture_output=quiet, timeout=300)
        return res.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


_lib = None


def load(auto_build: bool = True):
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(lib_path()) and auto_build and not build():
        return None
    if not os.path.exists(lib_path()):
        return None
    lib = ctypes.CDLL(lib_path())

    lib.gp_run_scenario.restype = ctypes.c_int
    lib.gp_run_scenario.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p]
    lib.gp_run_scenario_churn.restype = ctypes.c_int
    lib.gp_run_scenario_churn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p]
    lib.gp_run_conf.restype = ctypes.c_int
    lib.gp_run_conf.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_char_p]

    lib.gp_bus_create.restype = ctypes.c_void_p
    lib.gp_bus_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_double,
                                  ctypes.c_uint64]
    lib.gp_bus_destroy.argtypes = [ctypes.c_void_p]
    lib.gp_bus_init.restype = ctypes.c_int
    lib.gp_bus_init.argtypes = [ctypes.c_void_p]
    lib.gp_bus_send.restype = ctypes.c_int
    lib.gp_bus_send.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
    lib.gp_bus_recv.restype = ctypes.c_int
    lib.gp_bus_recv.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int)]
    lib.gp_bus_inflight.restype = ctypes.c_int
    lib.gp_bus_inflight.argtypes = [ctypes.c_void_p]
    lib.gp_bus_cleanup.restype = ctypes.c_int
    lib.gp_bus_cleanup.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gp_bus_counters.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint32),
                                    ctypes.POINTER(ctypes.c_uint32)]
    lib.gp_hash_uniform.restype = ctypes.c_double
    lib.gp_hash_uniform.argtypes = [ctypes.c_uint64] * 5

    _lib = lib
    return lib


def _require_lib():
    lib = load()
    if lib is None:
        raise RuntimeError(
            "native library unavailable — run `make libgossip_native.so` at "
            "the repo root (needs g++)")
    return lib


def require():
    """Build the library with make (a no-op when it is up to date) and
    load it; raises with make's output when the build fails."""
    try:
        res = subprocess.run(["make", LIB_NAME], cwd=_REPO_ROOT,
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"make {LIB_NAME} could not run: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"make {LIB_NAME} failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    return _require_lib()


def run_scenario(n: int, single_failure: bool, drop_msg: bool,
                 drop_prob: float, total_ticks: int, seed: int,
                 fail_ticks: Optional[Sequence[int]] = None,
                 outdir: str = ".") -> int:
    """Run one scenario on the native engine; writes the three logs."""
    lib = _require_lib()
    ft = None
    arr = None
    if fail_ticks is not None:
        arr = np.ascontiguousarray(fail_ticks, np.int32)
        if arr.shape != (n,):
            raise ValueError(f"fail_ticks must have shape ({n},), "
                             f"got {arr.shape}")
        ft = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    return lib.gp_run_scenario(n, int(single_failure), int(drop_msg),
                               drop_prob, total_ticks, seed, ft,
                               outdir.encode())


def run_scenario_churn(n: int, single_failure: bool, drop_msg: bool,
                       drop_prob: float, total_ticks: int, seed: int,
                       fail_ticks: Optional[Sequence[int]] = None,
                       rejoin_ticks: Optional[Sequence[int]] = None,
                       outdir: str = ".") -> int:
    """Churn variant: failed peers are wiped at their rejoin tick and
    re-enter through the normal JOINREQ path (Schedule.rejoin_tick's
    native twin)."""
    lib = _require_lib()

    def _ptr(ticks, name):
        if ticks is None:
            return None, None
        arr = np.ascontiguousarray(ticks, np.int32)
        if arr.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {arr.shape}")
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), arr

    ft, keep1 = _ptr(fail_ticks, "fail_ticks")
    rt, keep2 = _ptr(rejoin_ticks, "rejoin_ticks")
    if keep1 is not None and keep2 is not None:
        bad = (keep2 != np.iinfo(np.int32).max) & (keep2 <= keep1)
        if bad.any():
            # same rule the JAX schedule enforces (state.py): a rejoin
            # at or before the fail tick collapses the failed window
            raise ValueError(
                f"rejoin_ticks must be > fail_ticks (violated at peers "
                f"{np.flatnonzero(bad).tolist()})")
    return lib.gp_run_scenario_churn(n, int(single_failure), int(drop_msg),
                                     drop_prob, total_ticks, seed, ft, rt,
                                     outdir.encode())


def run_conf(conf_path: str, seed: int = 0, outdir: str = ".") -> int:
    return _require_lib().gp_run_conf(conf_path.encode(), seed,
                                      outdir.encode())


def hash_uniform(seed: int, a: int, b: int, c: int, d: int) -> float:
    return _require_lib().gp_hash_uniform(seed, a, b, c, d)


class NativeBus:
    """Python handle on the EmulNet-shaped native bus (plugin boundary).

    Mirrors the ENinit/ENsend/ENrecv/ENcleanup surface so harnesses (and
    tests) can drive the communication backend directly, as the reference
    driver drives EmulNet.
    """

    def __init__(self, max_nodes: int, total_ticks: int,
                 max_inflight: int = 30000, max_msg_size: int = 4000,
                 drop_prob: float = 0.0, seed: int = 0):
        self._lib = _require_lib()
        self._bus = self._lib.gp_bus_create(max_nodes, total_ticks,
                                            max_inflight, max_msg_size,
                                            drop_prob, seed)
        self.max_nodes = max_nodes
        self.total_ticks = total_ticks

    def close(self):
        if self._bus:
            self._lib.gp_bus_destroy(self._bus)
            self._bus = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def init(self) -> int:
        """ENinit: register the next peer; returns its 0-based index."""
        return self._lib.gp_bus_init(self._bus)

    def send(self, frm: int, to: int, payload: bytes, tick: int,
             drop_active: bool = False, channel: int = 0) -> bool:
        """ENsend: returns True iff enqueued (False = silently dropped)."""
        return bool(self._lib.gp_bus_send(self._bus, frm, to, payload,
                                          len(payload), tick,
                                          int(drop_active), channel))

    def recv(self, me: int, tick: int, chunk_msgs: int = 4096,
             chunk_bytes: int = 1 << 20) -> list[bytes]:
        """ENrecv: drain this peer's queued messages, in send order.

        Consumes in bounded chunks and loops until the queue is empty —
        a message larger than chunk_bytes raises instead of being lost
        (the C side leaves unfitting messages queued).
        """
        buf = ctypes.create_string_buffer(chunk_bytes)
        sizes = (ctypes.c_int * chunk_msgs)()
        more = ctypes.c_int(1)
        out = []
        while more.value:
            cnt = self._lib.gp_bus_recv(self._bus, me, tick, buf, chunk_bytes,
                                        sizes, chunk_msgs,
                                        ctypes.byref(more))
            if cnt == 0 and more.value:
                raise ValueError(
                    f"queued message exceeds chunk_bytes={chunk_bytes}")
            off = 0
            for k in range(cnt):
                out.append(buf.raw[off:off + sizes[k]])
                off += sizes[k]
        return out

    @property
    def inflight(self) -> int:
        return self._lib.gp_bus_inflight(self._bus)

    def cleanup(self, outdir: str = ".") -> bool:
        """ENcleanup: dump msgcount.log."""
        return bool(self._lib.gp_bus_cleanup(self._bus, outdir.encode()))

    def counters(self) -> tuple[np.ndarray, np.ndarray]:
        """(sent, recv) as (max_nodes, total_ticks) uint32 matrices."""
        sent = np.zeros((self.max_nodes, self.total_ticks), np.uint32)
        recv = np.zeros((self.max_nodes, self.total_ticks), np.uint32)
        self._lib.gp_bus_counters(
            self._bus, sent.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            recv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return sent, recv
