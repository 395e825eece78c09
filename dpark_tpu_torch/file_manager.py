"""Local files for the port's file sources (a cut-down copy of
dpark_tpu/file_manager: plain local paths only, no other scheme)."""

import os


def open_file(path, mode="rb"):
    return open(path, mode)


def walk(path):
    """(path, size) of `path` when it is a file, else of every regular
    file under it (names sorted within a directory), skipping
    dot-files."""
    if os.path.isfile(path):
        yield path, os.path.getsize(path)
        return
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    for root, _, names in os.walk(path):
        for n in sorted(names):
            if n.startswith("."):
                continue
            p = os.path.join(root, n)
            if os.path.isfile(p):
                yield p, os.path.getsize(p)
