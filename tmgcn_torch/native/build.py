"""Build the native host runtime with the host's C++ compiler.

    python -m tmgcn_torch.native.build

compiles ``tmgcn_native.cpp`` into ``build/tmgcn_torch_native/`` at the
root of the checkout (``g++ -O3 -march=native -std=c++17 -shared -fPIC``,
the JAX package's flags; ``$CXX`` names another compiler). The library is
named after a hash of the source, the command and what ``-march=native``
means on this host, so an edited source is rebuilt and a checkout shared
by two machines keeps one library for each CPU. It is written under a
temporary name and renamed, so processes that build at once (test
workers, ranks of a run) each load a whole file.
``native.load()`` builds it at first use. A failed build raises with the
command and the compiler's output: nothing falls back.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "tmgcn_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tmgcn_torch_native"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


@functools.cache
def _native_target(compiler: str) -> str:
    """The compiler's target options under -march=native on this host ("" if
    it does not run: the build then fails and says why)."""
    try:
        return subprocess.run([compiler, "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True).stdout
    except OSError:
        return ""


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library lives: keyed by the source, the compiler, its flags
    and this host's native target."""
    compiler = _compiler()
    key = (SOURCE.read_bytes() + " ".join((compiler, *FLAGS)).encode()
           + _native_target(compiler).encode())
    return Path(build_dir) / f"libtmgcn_native_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR, verbose: bool = False) -> Path:
    """The library's path, compiled first if it is not there yet."""
    path = library_path(build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *FLAGS, str(SOURCE), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native runtime build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, path)  # atomic: concurrent builds agree
    return path


if __name__ == "__main__":
    print(build(verbose=True))
