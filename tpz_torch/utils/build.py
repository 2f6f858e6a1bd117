"""Native libraries built once into build/ and rebuilt when their inputs
change. Concurrent callers (pytest-xdist workers) serialise on an fcntl
lock; the library appears by os.replace, so no caller loads a partial
file."""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform


def inputs_key(paths, *extra: str) -> str:
    """Digest of the files' names and contents, the extra strings, and
    the host (a build/ directory copied to another machine rebuilds)."""
    h = hashlib.sha256()
    for s in (*extra, platform.node(), platform.platform()):
        h.update(s.encode() + b"\0")
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def cached_build(out_dir: str, lib_name: str, key: str, compile_to) -> str:
    """Path of out_dir/lib_name, first calling compile_to(tmp_path) unless
    the library there was built from `key`."""
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, lib_name)
    stamp = lib_path + ".key"
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(lib_path) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read() == key:
                    return lib_path
        tmp = f"{lib_path}.tmp{os.getpid()}"
        compile_to(tmp)
        os.replace(tmp, lib_path)
        with open(stamp, "w") as f:
            f.write(key)
    return lib_path
