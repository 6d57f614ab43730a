"""Lua-style heterogeneous container (counterpart of
``bigdl_tpu/utils/table.py``, a copy without the JAX pytree
registration).

The reference's ``Table`` (utils/Table.scala:34): a 1-based,
insertion-ordered, heterogeneous dict used for multi-input /
multi-output activities and optimizer state.
"""
from __future__ import annotations


class Table:
    """1-based heterogeneous container (reference utils/Table.scala:34).

    Supports ``t[1]``, ``t['key']``, ``insert``, ``length``, ``flatten`` /
    ``inverse_flatten`` (reference Table.scala:230), and equality.
    """

    def __init__(self, *args, **kwargs):
        self._state = {}
        for i, v in enumerate(args):
            self._state[i + 1] = v
        self._state.update(kwargs)

    # -- dict-ish surface ------------------------------------------------
    def __getitem__(self, key):
        return self._state[key]

    def get(self, key, default=None):
        return self._state.get(key, default)

    def __setitem__(self, key, value):
        self._state[key] = value

    def __delitem__(self, key):
        del self._state[key]

    def __contains__(self, key):
        return key in self._state

    def __len__(self):
        return len(self._state)

    def length(self):
        """Count of consecutive integer keys starting at 1 (Lua semantics)."""
        n = 0
        while (n + 1) in self._state:
            n += 1
        return n

    def keys(self):
        return self._state.keys()

    def values(self):
        return self._state.values()

    def items(self):
        return self._state.items()

    def __iter__(self):
        return iter(self._state.values())

    # -- mutation helpers (reference Table.scala:120-180) ----------------
    def insert(self, *args):
        """``insert(obj)`` appends; ``insert(index, obj)`` inserts 1-based."""
        if len(args) == 1:
            self._state[self.length() + 1] = args[0]
        else:
            index, obj = args
            n = self.length()
            for i in range(n, index - 1, -1):
                self._state[i + 1] = self._state[i]
            self._state[index] = obj
        return self

    def remove(self, index=None):
        if index is None:
            index = self.length()
        if index not in self._state:
            return None
        obj = self._state[index]
        n = self.length()
        for i in range(index, n):
            self._state[i] = self._state[i + 1]
        if n in self._state and n >= index:
            del self._state[n]
        elif index in self._state and n == 0:
            del self._state[index]
        return obj

    def update(self, other):
        if isinstance(other, Table):
            other = other._state
        self._state.update(other)
        return self

    def copy(self):
        t = Table()
        t._state = dict(self._state)
        return t

    # -- flatten / inverse_flatten (reference Table.scala:230-290) -------
    def flatten(self):
        """Flatten nested integer-keyed Tables into one flat Table."""
        out = Table()
        for v in self:
            if isinstance(v, Table):
                for leaf in v.flatten():
                    out.insert(leaf)
            else:
                out.insert(v)
        return out

    def inverse_flatten(self, flat):
        """Rebuild this Table's nesting from a flat Table of leaves."""
        leaves = list(flat)
        idx = 0

        def rebuild(template):
            nonlocal idx
            out = Table()
            for v in template:
                if isinstance(v, Table):
                    out.insert(rebuild(v))
                else:
                    out.insert(leaves[idx])
                    idx += 1
            return out

        return rebuild(self)

    # -- misc ------------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, Table):
            return NotImplemented
        if set(self._state.keys()) != set(other._state.keys()):
            return False
        for k, v in self._state.items():
            ov = other._state[k]
            try:
                eq = v == ov
                if hasattr(eq, "all"):
                    eq = bool(eq.all())
                if not eq:
                    return False
            except Exception:
                return False
        return True

    def __hash__(self):
        return id(self)

    def __repr__(self):
        inner = ", ".join(f"{k}: {v!r}" for k, v in self._state.items())
        return "{" + inner + "}"


def T(*args, **kwargs):
    """Constructor mirroring the reference's ``T()`` (Table.scala:300-330)."""
    return Table(*args, **kwargs)

