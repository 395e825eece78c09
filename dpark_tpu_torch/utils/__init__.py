"""Host helpers of the PyTorch port (own copies; the port imports
nothing of the JAX package)."""


def builtin_globals_ok(f, code=None):
    """Every global `f`'s bytecode references still resolves to the
    builtin of that name — the proof obligation of the bytecode-template
    classifiers in utils/monoid.py: a local `sum` shadowing the builtin
    defeats template equality."""
    import builtins
    code = code if code is not None else f.__code__
    fglobals = f.__globals__
    fbuiltins = fglobals.get("__builtins__", builtins)
    for g in code.co_names:
        expected = getattr(builtins, g, None)
        if expected is None:
            return False
        if g in fglobals:
            if fglobals[g] is not expected:
                return False
        elif isinstance(fbuiltins, dict):
            if fbuiltins.get(g) is not expected:
                return False
        elif getattr(fbuiltins, g, None) is not expected:
            return False
    return True
