"""A run that two test modules share, made once a test session: the first
caller makes the file under a lock in the session's temporary directory
(the one every ``pytest-xdist`` worker of the session shares), the others
wait on the lock and read the same file. Nothing here imports ``jax``."""
from __future__ import annotations

import fcntl
import os


def once(tmp_path_factory, name: str, make) -> str:
    """The path of the session's file ``name``; ``make(path)`` writes it,
    in the first caller only."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent          # shared by the session's workers
    path = str(root / name)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                # the same suffix (numpy's savez appends ".npz" otherwise)
                part = str(root / f"part_{name}")
                make(part)
                os.rename(part, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path
