"""Lightweight pytree-module base class.

The reference (``src/qinfer/abstract_model.py``, ``src/qinfer/distributions.py``)
expresses models, priors and resamplers as plain Python classes holding NumPy
state. Everything that crosses a ``jit`` boundary must be a pytree, so
``qinfer_tpu`` gives every model / distribution / resampler a tiny common base,
:class:`Module`, that auto-registers subclasses with
``jax.tree_util``:

* attributes that are JAX/NumPy arrays or nested :class:`Module` s become
  pytree *children* (traced through ``jit`` / ``vmap`` / ``scan``);
* every other attribute (ints, floats, strings, dtypes, callables, tuples)
  is *static* metadata and participates in the jit cache key.

This is the idiomatic JAX analogue of the reference's class hierarchy: the
class instance can be passed straight into jitted functions, sharded, donated
or closed over, with zero translation layers. (Same spirit as flax.struct /
equinox, implemented minimally to avoid extra dependencies.)
"""

from __future__ import annotations

import numpy as np
import jax

__all__ = ["Module", "field_names"]


def _is_array(x):
    return isinstance(x, (jax.Array, np.ndarray, np.generic))


def _is_child(x):
    """A value stored on a Module is a pytree child if it is an array, a
    nested Module, or a list/tuple/dict containing any of those."""
    if _is_array(x) or isinstance(x, Module):
        return True
    if isinstance(x, (list, tuple)):
        return any(_is_child(v) for v in x)
    if isinstance(x, dict):
        return any(_is_child(v) for v in x.values())
    return False


class _FrozenDict(tuple):
    """Marker: a dict frozen for hashing; ``_thaw`` restores the dict."""


class _FrozenList(tuple):
    """Marker: a list frozen for hashing; ``_thaw`` restores the list."""


def _freeze(x):
    """Best-effort conversion of a static value to something hashable.

    Container types are tagged with marker tuples so ``_thaw`` can restore
    the original type on unflatten — a static ``other_fields`` dict must
    still be a dict on the reconstructed Module, not a tuple of pairs.
    """
    if isinstance(x, list):
        return _FrozenList(_freeze(v) for v in x)
    if isinstance(x, tuple):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return _FrozenDict(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, set):
        return frozenset(_freeze(v) for v in x)
    if isinstance(x, np.dtype):
        return str(x)
    return x


class _Static:
    """Hashable wrapper around the static attribute dict of a Module."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items  # tuple of (name, frozen_value)

    def __hash__(self):
        try:
            return hash(self.items)
        except TypeError:
            # unhashable static (e.g. a lambda-in-list); fall back to repr
            return hash(repr(self.items))

    def __eq__(self, other):
        return isinstance(other, _Static) and self.items == other.items

    def __repr__(self):  # pragma: no cover - debug aid
        return f"_Static({self.items!r})"


class Module:
    """Base class whose subclasses are automatically registered as pytrees.

    Subclasses just assign attributes in ``__init__`` as usual. Attribute
    *order of definition* is preserved for flatten/unflatten stability.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        jax.tree_util.register_pytree_node(
            cls,
            lambda self: self._tree_flatten(),
            lambda aux, children: cls._tree_unflatten(aux, children),
        )

    # -- pytree protocol ---------------------------------------------------
    def _tree_flatten(self):
        child_names, children, static_items = [], [], []
        for name, value in self.__dict__.items():
            if name.startswith("_"):
                # Underscore attributes are host-side mutable bookkeeping
                # (call counters, debug records). Excluding them keeps the
                # jit cache key stable as they mutate; unflattened copies
                # simply lack them (all readers use getattr defaults).
                continue
            if _is_child(value):
                child_names.append(name)
                children.append(value)
            else:
                static_items.append((name, _freeze(value)))
        aux = (tuple(child_names), _Static(tuple(static_items)))
        return children, aux

    @classmethod
    def _tree_unflatten(cls, aux, children):
        child_names, static = aux
        obj = object.__new__(cls)
        for name, value in zip(child_names, children):
            object.__setattr__(obj, name, value)
        for name, value in static.items:
            object.__setattr__(obj, name, _thaw(value))
        return obj

    # -- conveniences ------------------------------------------------------
    def replace(self, **updates):
        """Return a shallow copy with the given attributes replaced."""
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj.__dict__.update(updates)
        return obj

    def __repr__(self):
        cls = type(self).__name__
        parts = []
        for name, value in self.__dict__.items():
            if _is_array(value):
                parts.append(f"{name}=<array {getattr(value, 'shape', ())}>")
            else:
                parts.append(f"{name}={value!r}")
        return f"{cls}({', '.join(parts)})"


def _thaw(x):
    """Inverse of ``_freeze`` for the marker-tagged containers (plain
    tuples stay tuples; dtypes stay strings — every consumer passes them
    back through ``np.dtype``)."""
    if isinstance(x, _FrozenDict):
        return {k: _thaw(v) for k, v in x}
    if isinstance(x, _FrozenList):
        return [_thaw(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_thaw(v) for v in x)
    return x


def field_names(module):
    """Names of all attributes stored on a Module instance."""
    return tuple(module.__dict__.keys())
