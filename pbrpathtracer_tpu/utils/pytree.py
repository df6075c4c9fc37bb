"""Frozen dataclasses registered as JAX pytrees.

Fields declared with ``static_field`` are static metadata: they are not
traced and take part in the jit cache key. Every other field is a leaf
(or a sub-pytree, or None).
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Decorator: frozen dataclass + pytree registration + ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)


def static_field(default):
    """A dataclass field kept as static pytree metadata."""
    return dataclasses.field(default=default, metadata={"static": True})
