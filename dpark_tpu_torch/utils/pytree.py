"""Nested-value flattening with jax.tree_util's rules for plain Python
containers (the port's own copy: it imports no jax).

Tuples, lists and dicts are nodes (a dict's children in sorted key
order), a namedtuple is a node of its own type, ``None`` is an empty
subtree, and anything else (a number, a numpy array, a torch tensor) is
a leaf.  Two values have equal treedefs exactly when jax.tree_util's
treedefs of them are equal: ``(1, 2)`` and ``[1, 2]`` differ,
``{"a": 1, "b": 2}`` and ``{"b": 3, "a": 4}`` agree.

torch.utils._pytree is not used: it treats ``None`` as a leaf.
"""

LEAF = "*"
_NONE = ("none",)


def tree_flatten(x):
    """(leaves, treedef) of a nested value."""
    leaves = []

    def walk(v):
        if v is None:
            return _NONE
        if isinstance(v, tuple):
            cls = type(v) if hasattr(v, "_fields") else None
            return ("tuple", cls, tuple(walk(c) for c in v))
        if isinstance(v, list):
            return ("list", tuple(walk(c) for c in v))
        if isinstance(v, dict):
            keys = tuple(sorted(v))
            return ("dict", keys, tuple(walk(v[k]) for k in keys))
        leaves.append(v)
        return LEAF
    return leaves, walk(x)


def tree_unflatten(treedef, leaves):
    """The value of `treedef` built from `leaves` (consumed in order)."""
    it = iter(leaves)

    def build(t):
        if t == LEAF:
            return next(it)
        if t == _NONE:
            return None
        if t[0] == "tuple":
            kids = [build(c) for c in t[2]]
            return t[1](*kids) if t[1] is not None else tuple(kids)
        if t[0] == "list":
            return [build(c) for c in t[1]]
        return {k: build(c) for k, c in zip(t[1], t[2])}
    return build(treedef)


def tree_structure(x):
    return tree_flatten(x)[1]
