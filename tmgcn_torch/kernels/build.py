"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, named after a hash of its
source and flags so an edited kernel is rebuilt. Libraries go to
``build/tmgcn_torch_kernels/`` at the root of the checkout. The sources
compile in parallel, one ``nvcc`` each, at first use or when
``python -m tmgcn_torch.kernels.build`` is run (which also prints ptxas's
register and spill report).

    python -m tmgcn_torch.kernels.build --compare-with OTHER_CSRC

builds the sources of another ``csrc`` directory (say, an earlier commit's)
with the same flags and says, for each of its kernels, which kernel of this
tree compiles to the same SASS: a check that a change to a shared header
left the other kernels' code as it was.

Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tmgcn_torch_kernels"
SOURCES = ("windowed_segment_matmul.cu", "windowed_tiled_segment_matmul.cu", "lstm_scan.cu")
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
    """Where the library of one source lives: keyed by source, headers and flags."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def _compile(sources: dict[Path, Path], verbose: bool) -> None:
    """nvcc each source into its library path, all at once; raises with
    nvcc's output if any build fails."""
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = {}
    for src, path in sources.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
        procs[src] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for src, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {src.name}]\n{log}", file=sys.stderr)
        os.replace(tmp, sources[src])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing; all nvcc at once.

    verbose=True adds ``-Xptxas -v`` and prints the compiler's report of
    registers, shared memory and spills. Raises with nvcc's output if any
    build fails.
    """
    paths = {src: library_path(src) for src in SOURCES}
    todo = {CSRC / src: p for src, p in paths.items() if not p.exists()}
    if todo:
        _compile(todo, verbose)
    return paths


def sass(lib: Path) -> dict[str, list[str]]:
    """Each kernel of a built library as its SASS instructions
    (``cuobjdump -sass``; addresses and encodings dropped), by demangled name."""
    tools = Path(_nvcc()).parent
    dump = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    kernels: dict[str, list[str]] = {}
    body: list[str] | None = None
    for line in dump.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            body = kernels.setdefault(m.group(1), [])
        elif body is not None and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)):
            body.append(m.group(1))
    names = list(kernels)
    plain = subprocess.run([str(tools / "cu++filt")], input="\n".join(names),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    return {p: kernels[n] for n, p in zip(names, plain)}


def compare_with(other_csrc: Path) -> int:
    """Build another csrc tree's sources and report, for each of its
    kernels, the kernel of this tree with the same SASS; 1 if one has none."""
    other_csrc = Path(other_csrc).resolve()
    others = {other_csrc / src: BUILD_DIR / "compare" / f"lib{Path(src).stem}.so"
              for src in SOURCES if (other_csrc / src).exists()}
    _compile(others, verbose=False)
    ours: dict[str, list[str]] = {}
    for path in build_all().values():
        ours.update(sass(path))
    missing = 0
    for lib in others.values():
        for name, body in sass(lib).items():
            same = [n for n, b in ours.items() if b == body]
            missing += not same
            print(f"{name} ({len(body)} instructions): "
                  + (f"same SASS as {' / '.join(same)}" if same else "NO kernel of this tree matches"))
    return 1 if missing else 0


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    return ctypes.CDLL(str(build_all()[source]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare-with"] and len(sys.argv) == 3:
        raise SystemExit(compare_with(Path(sys.argv[2])))
    if sys.argv[1:]:
        raise SystemExit("usage: python -m tmgcn_torch.kernels.build [--compare-with OTHER_CSRC]")
    for src, path in build_all(verbose=True).items():
        print(f"{src} -> {path}")
