"""Peer addressing (copy of ``gossip_protocol_tpu/addressing.py``).

The reference represents a peer address as 6 raw bytes — a little-endian
int32 id plus an int16 port (Member.h:29-55) — assigned sequentially from
1 by ``EmulNet::ENinit`` (EmulNet.cpp:72-77) with port forced to 0.  The
log grammar prints addresses byte-wise as ``b0.b1.b2.b3:port``
(Log.cpp:73).

In the TPU framework a peer *is* its index ``i`` (0-based) into the state
tensors; the wire/log identity ``id = i + 1`` exists only at the
observability boundary.  These helpers convert between the two.
"""

from __future__ import annotations


def peer_id(index: int) -> int:
    """0-based tensor index -> reference peer id (EmulNet.cpp:74)."""
    return index + 1


def peer_index(pid: int) -> int:
    """Reference peer id -> 0-based tensor index."""
    return pid - 1


def addr_str(index: int, port: int = 0) -> str:
    """Dotted log form of a peer address, e.g. index 0 -> ``"1.0.0.0:0"``.

    Matches ``sprintf("%d.%d.%d.%d:%d", ...)`` over the little-endian id
    bytes (Log.cpp:73, Log.cpp:118).
    """
    pid = peer_id(index)
    b = [(pid >> (8 * k)) & 0xFF for k in range(4)]
    return f"{b[0]}.{b[1]}.{b[2]}.{b[3]}:{port}"


def parse_addr(s: str) -> int:
    """Dotted log form -> 0-based peer index (inverse of :func:`addr_str`)."""
    dotted, _, _port = s.partition(":")
    b = [int(x) for x in dotted.split(".")]
    pid = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
    return peer_index(pid)


def display_addr(index: int, port: int = 0) -> str:
    """``Address::getAddress()`` form, e.g. ``"1:0"`` (Member.h:46-52).

    Used by the reference's per-node stdout line (Application.cpp:146).
    """
    return f"{peer_id(index)}:{port}"
