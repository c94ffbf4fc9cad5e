"""Named flattening of nested parameter dicts.

Counterpart of ``dgc_tpu/utils/pytree.py``: every leaf gets an ``a/b/c``
path name, in the order ``jax.tree_util`` flattens a nested dict — keys
**sorted** at every level (so a flax ResNet's ``BasicBlock_0..8`` come
before ``BatchNorm_0``, ``Conv_0`` and ``Dense_0``). The flat-buffer
layout is a function of this order, so it must be reproduced exactly.
"""

from collections.abc import Mapping
from typing import Any, Dict

__all__ = ["named_flatten", "nest"]


def named_flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested mapping -> ``{path name: leaf}`` in sorted-key order."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(named_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def nest(named: Dict[str, Any], sep: str = "/") -> Dict[str, Any]:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}`` (inverse of
    :func:`named_flatten` up to key order)."""
    out: Dict[str, Any] = {}
    for name, leaf in named.items():
        node = out
        *heads, last = name.split(sep)
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out
