"""Nested-dict pytree helpers (dotted-path flatten/unflatten).

Used by the checkpoint format and the .pth/.keras importers to move between
``{"down1": {"0": {"kernel": ...}}}`` trees and ``"down1.0.kernel"`` keys.
"""

from __future__ import annotations

from typing import Any, Dict


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def set_path(tree: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def get_path(tree: Dict[str, Any], path: str, default=None) -> Any:
    node: Any = tree
    for p in path.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node
