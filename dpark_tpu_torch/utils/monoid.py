"""EXACT algebraic classification of 2-arg merge callables and of
1-arg per-group aggregates (port of dpark_tpu/utils/monoid.py), plus
the monoid identities (from dpark_tpu/bagel.py monoid_identity); the
masked reductions themselves are K17 (kernels.monoid_reduce).

A classified monoid unlocks the single-pass segment reduction of K3
instead of the traced scan of the user's function; a wrong answer here
silently replaces the user's function, so only provable matches qualify:

* a known callable by identity (operator.add, min, np.maximum, torch.add,
  ...);
* a closure-free 2-arg Python function whose bytecode equals one of the
  canonical forms ``a+b``, ``b+a``, ``a*b``, ``b*a``, ``min(a,b)``,
  ``max(a,b)`` — with any referenced global verified to still be the
  builtin;
* an explicit user hint: ``merge.__dpark_monoid__ = "add"``.
"""

import operator

import numpy as np

from dpark_tpu_torch.utils import builtin_globals_ok

KINDS = ("add", "min", "max", "mul")

_DIRECT = {operator.add: "add", operator.iadd: "add",
           operator.mul: "mul", operator.imul: "mul",
           min: "min", max: "max",
           np.add: "add", np.multiply: "mul",
           np.minimum: "min", np.maximum: "max"}

_TEMPLATES = None


def register_direct(mapping):
    """Backends register extra by-identity callables (torch.add, ...)."""
    assert all(v in KINDS for v in mapping.values()), mapping
    _DIRECT.update(mapping)


def _templates():
    global _TEMPLATES
    if _TEMPLATES is None:
        tmpl = {
            "add": [lambda a, b: a + b, lambda a, b: b + a],
            "mul": [lambda a, b: a * b, lambda a, b: b * a],
            "min": [lambda a, b: min(a, b)],
            "max": [lambda a, b: max(a, b)],
        }
        _TEMPLATES = {}
        for name, fns in tmpl.items():
            for f in fns:
                c = f.__code__
                _TEMPLATES[(c.co_code, c.co_consts, c.co_names)] = name
    return _TEMPLATES


SEGAGG_KINDS = ("sum", "count", "min", "max", "mean")

_SEGAGG_DIRECT = {sum: "sum", len: "count", min: "min", max: "max",
                  np.sum: "sum", np.mean: "mean",
                  np.min: "min", np.max: "max"}

_SEGAGG_TEMPLATES = None


def _segagg_templates():
    global _SEGAGG_TEMPLATES
    if _SEGAGG_TEMPLATES is None:
        tmpl = {
            "sum": [lambda vs: sum(vs)],
            "count": [lambda vs: len(vs)],
            "min": [lambda vs: min(vs)],
            "max": [lambda vs: max(vs)],
            "mean": [lambda vs: sum(vs) / len(vs)],
        }
        _SEGAGG_TEMPLATES = {}
        for name, fns in tmpl.items():
            for f in fns:
                c = f.__code__
                _SEGAGG_TEMPLATES[(c.co_code, c.co_consts,
                                   c.co_names)] = name
    return _SEGAGG_TEMPLATES


def classify_segagg(f):
    """EXACT classification of a 1-arg function applied to a groupByKey
    value LIST as a per-group aggregate.  Same proof obligations as
    classify_merge — only provable matches qualify:

    * the builtins sum/len/min/max (or np.sum/np.mean/np.min/np.max)
      by identity;
    * a closure-free 1-arg function whose bytecode equals ``sum(vs)``,
      ``len(vs)``, ``min(vs)``, ``max(vs)`` or ``sum(vs)/len(vs)``,
      with referenced globals verified to still be the builtins;
    * an explicit hint: ``f.__dpark_segagg__ = "sum"``.

    Returns "sum" | "count" | "min" | "max" | "mean" | None."""
    hint = getattr(f, "__dpark_segagg__", None)
    if hint in SEGAGG_KINDS:
        return hint
    try:
        if f in _SEGAGG_DIRECT:
            return _SEGAGG_DIRECT[f]
    except TypeError:
        return None
    code = getattr(f, "__code__", None)
    if code is None or getattr(f, "__closure__", None):
        return None
    if code.co_argcount != 1 or code.co_flags & 0x0C:
        return None
    name = _segagg_templates().get((code.co_code, code.co_consts,
                                    code.co_names))
    if name is None or not builtin_globals_ok(f, code):
        return None
    return name


def classify_merge(merge):
    """"add" | "min" | "max" | "mul" | None."""
    hint = getattr(merge, "__dpark_monoid__", None)
    if hint in KINDS:
        return hint
    try:
        if merge in _DIRECT:
            return _DIRECT[merge]
    except TypeError:
        return None                      # unhashable callable
    code = getattr(merge, "__code__", None)
    if code is None or getattr(merge, "__closure__", None):
        return None
    if code.co_argcount != 2 or code.co_flags & 0x0C:   # *args/**kwargs
        return None
    name = _templates().get((code.co_code, code.co_consts,
                             code.co_names))
    if name is None:
        return None
    if not builtin_globals_ok(merge, code):
        return None
    return name


def monoid_identity(kind, dtype):
    """Identity element of a monoid for a numpy dtype."""
    dt = np.dtype(dtype)
    if kind == "add":
        return dt.type(0)
    if kind == "mul":
        return dt.type(1)
    if dt.kind == "f":
        return dt.type(np.inf if kind == "min" else -np.inf)
    return np.iinfo(dt).max if kind == "min" else np.iinfo(dt).min
