"""The JAX package's native host library, built once and whole before any
port test compares against it.

``tmgcn_tpu.native`` builds ``_tmgcn_native.so`` at first use with g++
writing straight onto the final path, and a process whose ``ctypes.CDLL``
meets a half-written file gives up on the library for its whole life
(``_load_failed``). Under ``pytest -n 6`` on a tree without the library,
six workers build it at once: a worker that lost the race then skips the
tests guarded by ``native.available()`` and draws other LP negatives (the
numpy fallback's) than the port's C++ sampler, so the comparisons that
have no guard fail.

Importing this module (every port test module that uses the JAX package's
sampler or parser does, and xdist workers collect every module before they
run a test) takes an exclusive lock on a file under ``build/``, builds the
library with the JAX package's own ``build.build`` where it is missing or
does not load, waits out a build that another process started without the
lock (the JAX suite's ``tests/test_native.py`` builds at collection), and
releases the lock. A process that gave up on the library while the file
was being written is told to load it again. Nothing is built where g++ is
missing: the tests' own ``pytest.skip`` guards cover that host.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
import time
from pathlib import Path

from tmgcn_tpu import native
from tmgcn_tpu.native import build as native_build

LOCK = Path(__file__).resolve().parents[1] / "build" / "tmgcn_tpu_native.lock"
# A build another process runs without the lock ends within this time.
SETTLE_S = 120.0


def _loads(path: Path) -> bool:
    try:
        ctypes.CDLL(str(path))
    except OSError:
        return False
    return True


def ensure_built() -> bool:
    """Build the library under the lock where it is missing or broken;
    True once it loads."""
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    so = native_build.OUTPUT
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + SETTLE_S
            built = False
            while not (so.exists() and _loads(so)):
                if not built:
                    try:
                        native_build.build(verbose=False)
                    except (OSError, subprocess.CalledProcessError):
                        return False  # no toolchain
                    built = True
                    continue
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.5)  # another process's g++ is still writing it
            if native._load_failed:
                # This process met the file half-written: load it anew.
                native._load_failed = False
                native._lib = None
            return True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


AVAILABLE = ensure_built()
