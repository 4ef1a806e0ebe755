"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, named after a hash of its
source and flags so an edited kernel is rebuilt. Libraries go to
``build/tmgcn_torch_kernels/`` at the root of the checkout. The sources
compile in parallel, one ``nvcc`` each, at first use or when
``python -m tmgcn_torch.kernels.build`` is run.

Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tmgcn_torch_kernels"
SOURCES = ("windowed_segment_matmul.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels of tmgcn_torch are built on a machine with the CUDA toolkit"
        )
    return found


def library_path(source: str) -> Path:
    """Where the library of one source lives: keyed by source and flags."""
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing; all nvcc at once.

    verbose=True adds ``-Xptxas -v`` and prints the compiler's report of
    registers, shared memory and spills. Raises with nvcc's output if any
    build fails.
    """
    paths = {src: library_path(src) for src in SOURCES}
    todo = {src: p for src, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = {}
    for src, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for src, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {src}]\n{log}", file=sys.stderr)
        os.replace(tmp, paths[src])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    return ctypes.CDLL(str(build_all()[source]))


if __name__ == "__main__":
    for src, path in build_all(verbose=True).items():
        print(f"{src} -> {path}")
