"""Shared AST plumbing for the source passes (purity_lint, cache_keys):
one definition each, so the two passes resolve chains alike."""

from __future__ import annotations

import ast
import os

#: repository root (the directory holding gossip_protocol_tpu_torch/)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def attr_chain(node) -> list[str]:
    """``a.b.c`` -> ['a', 'b', 'c']; [] when the root is not a Name
    (a call result, a subscript — chains the passes cannot reason
    about and deliberately skip)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []
