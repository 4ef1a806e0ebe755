"""The port's native host runtime (tmgcn_torch/native) against its numpy
plain versions and against the JAX package's library on the same inputs.

Every comparison is bitwise (values and dtypes):

* the negative sampler: ``native.sample_negatives`` against
  ``sampling.sample_negatives_splitmix64`` and ``tmgcn_tpu.native``'s, over
  several seeds, a dense graph where most draws are rejected, ``to_add`` 0;
  ``augment_edges`` with either stream source against the JAX package's;
* the packer: ``native.pack_chunks`` against the numpy packing and
  ``tmgcn_tpu.native``'s, with empty windows, a window of exactly ``chunk``
  entries, a single entry, no entry; ``pack_windowed_flat`` with either
  packer (row index included);
* the parser: each registry format (the stand-ins in data/synthetic/ and a
  chess-format file) and small files written here with ``%`` and ``#``
  comments, a header row, a last line without a newline, runs of
  whitespace, a negative weight and a fractional timestamp: ``parse_edges``
  against ``parse_edges_numpy`` (``np.loadtxt``'s columns) and
  ``tmgcn_tpu.native``'s, and ``load_raw`` with either parser against the
  JAX package's.

A caller's plain path is reached by putting the plain version in the
native entry point's place (``monkeypatch``), as chip_smoke.py does.

And the build: two processes building into one empty directory at once
both load the same library; a compiler that fails raises with its command
and output; a runtime that does not load makes ``load_raw`` raise, with no
numpy fallback.

The comparisons with ``tmgcn_tpu.native`` skip where the JAX package's
library does not load (it then samples another stream).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.torch_registry import SYNTHETIC
from tmgcn_tpu import native as jnative
from tmgcn_tpu.preprocess import datasets as jds
from tmgcn_tpu.tasks import sampling as js
from tmgcn_torch import native
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.native import build as nbuild
from tmgcn_torch.preprocess import datasets as tds
from tmgcn_torch.tasks import sampling as ts

ROOT = Path(__file__).resolve().parents[1]


def _need_jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library did not load")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- sampler

def _keys(seed: int, n_nodes: int, n_real: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_nodes, n_real) * n_nodes + rng.integers(0, n_nodes, n_real)


SAMPLER_CASES = {
    "sparse-seed0": (0, 500, 300, 1_000),
    "sparse-seed7": (7, 500, 300, 1_000),
    "big-seed": (2**40 + 3, 1_000, 5_000, 20_000),
    "dense-rejecting": (1, 12, 400, 300),  # 135 of the 144 pairs are real
    "to-add-0": (2, 50, 40, 0),
    "no-real-edge": (3, 30, 0, 50),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_matches_numpy_and_jax(case):
    seed, n_nodes, n_real, to_add = SAMPLER_CASES[case]
    keys = _keys(seed, n_nodes, n_real)
    got = native.sample_negatives(keys, n_nodes, to_add, seed)
    _same(got, ts.sample_negatives_splitmix64(keys, n_nodes, to_add, seed))
    assert not np.isin(got[0].astype(np.int64) * n_nodes + got[1], keys).any()
    _need_jax_native()
    _same(got, jnative.sample_negatives(keys, n_nodes, to_add, seed))


def test_dense_graph_rejects_most_draws():
    keys = np.unique(_keys(1, 12, 400))
    src, trg = native.sample_negatives(keys, 12, 300, 1)
    assert len(keys) > 0.9 * 144 and len(np.unique(src * 12 + trg)) <= 144 - len(keys)


@pytest.mark.parametrize("seed", [0, 5])
def test_augment_edges_impls_match_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    E = 400
    edges = np.stack([np.sort(rng.choice([0, 1, 3, 4], E)), rng.integers(0, 60, E),
                      rng.integers(0, 60, E)])
    got = ts.augment_edges(edges, 60, 19, 3, 3, seed=seed)
    with monkeypatch.context() as m:
        m.setattr(native, "sample_negatives", ts.sample_negatives_splitmix64)
        _same(got, ts.augment_edges(edges, 60, 19, 3, 3, seed=seed))
    _need_jax_native()
    _same(got, js.augment_edges(edges, 60, 19, 3, 3, seed=seed))


def test_only_the_all_windows_packing_is_native(monkeypatch):
    """Without every window the packer is the numpy one (as in the JAX
    package); with every window it is the native runtime's."""
    def broken(*args):
        raise RuntimeError("native pack_chunks")

    monkeypatch.setattr(native, "pack_chunks", broken)
    rows, cols, vals, n_out = _stream("empty-windows", 64, 128)
    p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, all_windows=False)
    assert 1 not in p.window_id.tolist()
    with pytest.raises(RuntimeError, match="native pack_chunks"):
        tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128)


# ----------------------------------------------------------------- packer

def _stream(kind: str, chunk: int, window: int):
    """(rows, cols, vals, n_out): sorted rows with the layout ``kind`` names."""
    rng = np.random.default_rng(len(kind))
    n_out = 10 * window + 7  # a ragged last window
    if kind == "random":
        rows = np.sort(rng.integers(0, n_out, 3_000))
    elif kind == "empty-windows":  # windows 1, 4-8 empty
        keep = rng.integers(0, n_out, 2_000)
        rows = np.sort(keep[(keep // window != 1) & ((keep // window < 4) | (keep // window > 8))])
    elif kind == "exactly-one-chunk":  # window 3 holds exactly `chunk` entries
        rows = np.sort(np.r_[rng.integers(0, window, 50), 3 * window + rng.integers(0, window, chunk),
                             9 * window + rng.integers(0, window, 10)])
    elif kind == "single-entry":
        rows = np.array([5 * window + 3])
    else:  # no entry: every window gets an empty chunk
        rows = np.zeros(0, np.int64)
    cols = rng.integers(0, 999, len(rows))
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows.astype(np.int64), cols, vals, n_out


PACK_KINDS = ["random", "empty-windows", "exactly-one-chunk", "single-entry", "no-entry"]


@pytest.mark.parametrize("kind", PACK_KINDS)
def test_pack_chunks_matches_numpy_and_jax(kind):
    chunk, window = 64, 128
    rows, cols, vals, n_out = _stream(kind, chunk, window)
    n_windows = -(-n_out // window)
    got = native.pack_chunks(rows, cols, vals.astype(np.float64), window, chunk, n_windows)
    plain = tk.pack_chunks_numpy(rows, cols, vals.astype(np.float64), window, chunk, n_windows)
    _same(got, plain)
    assert sorted(set(got[3].tolist())) == list(range(n_windows))  # every window
    if kind == "exactly-one-chunk":
        assert (got[3] == 3).sum() == 1
    _need_jax_native()
    _same(got, jnative.pack_chunks(rows, cols, vals, window, chunk, n_windows))


FIELDS = ("rows", "cols", "vals", "window_id", "is_first", "window_ptr", "entry_order",
          "row_ptr")


@pytest.mark.parametrize("sort_cols", [False, True])
@pytest.mark.parametrize("kind", PACK_KINDS)
def test_pack_windowed_flat_impls_agree(kind, sort_cols, monkeypatch):
    rows, cols, vals, n_out = _stream(kind, 64, 128)
    got = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, sort_cols)
    monkeypatch.setattr(native, "pack_chunks", tk.pack_chunks_numpy)
    ref = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, sort_cols)
    assert got.n_rows_out == ref.n_rows_out
    _same([getattr(got, f) for f in FIELDS], [getattr(ref, f) for f in FIELDS])


# ----------------------------------------------------------------- parser

# name -> (file text, delimiter, skiprows, comment, columns)
PARSER_CASES = {
    "percent-comments": ("% a comment\n%another\n1 2 1 10\n% mid\n3 1 -1 12\n", None, 0, "%",
                         (0, 1, 2, 3)),
    "hash-comments": ("# c\n1,2,3,4\n#x,y\n5,6,7,8\n", ",", 0, "#", (0, 1, 2, 3)),
    "header-row": ("src\tdst\tx\tt\tw\n1\t2\t0\t100\t1\n2\t3\t0\t90\t-1\n", "\t", 1, "#",
                   (0, 1, 4, 3)),
    "no-final-newline": ("1 2 1 5\n2 3 1 6\n3 1 -1 7", None, 0, "%", (0, 1, 2, 3)),
    "whitespace-runs": ("  1   2\t\t1  5\n\t2 3 1    6  \n\n   \n3  1 -1 7\n", None, 0, "%",
                        (0, 1, 2, 3)),
    "negative-weight": ("1,2,-10,1000\n2,1,-0.5,1001\n3,2,7,1002\n", ",", 0, "#", (0, 1, 2, 3)),
    "fractional-timestamp": ("0.25 1 2 1\n1.0625 2 3 1\n3.75 3 1 2\n10.5 1 3 1\n", None, 0, "#",
                             (1, 2, 3, 0)),
    "header-and-comments": ("% konect\n% 4 5\n1 2 1 10\n2 3 1 11\n", None, 1, "%", (0, 1, 2, 3)),
}


def _write(tmp_path, text: str, name: str = "edges.txt") -> Path:
    path = tmp_path / name
    path.write_bytes(text.encode())
    return path


@pytest.mark.parametrize("case", list(PARSER_CASES))
def test_parse_edges_edge_cases(tmp_path, case):
    text, delim, skip, comment, cols = PARSER_CASES[case]
    path = _write(tmp_path, text)
    got = native.parse_edges(path, cols, delim, skip, comment)
    _same([got], [tds.parse_edges_numpy(path, cols, delim, skip, comment)])
    assert got.shape[0] >= 2
    _need_jax_native()
    _same([got], [jnative.parse_edges(path, list(cols), delim, skip, comment)])


@pytest.mark.parametrize("case", ["percent-comments", "whitespace-runs", "no-final-newline",
                                  "fractional-timestamp", "header-row"])
def test_load_raw_edge_cases_match_jax(tmp_path, case, monkeypatch):
    """load_raw with either parser against the JAX package's, on a registry
    entry whose parse settings are the case's."""
    text, delim, skip, comment, cols = PARSER_CASES[case]
    time_delta = 1.0 if case == "fractional-timestamp" else None
    kw = dict(name="case", filename="edges.txt", delimiter=delim, skiprows=skip, columns=cols,
              comments=comment)
    spec_t = tds.DatasetSpec(preprocess=tds.PreprocessConfig(2, 1, 1, time_delta=time_delta),
                             **kw)
    spec_j = jds.DatasetSpec(preprocess=jds.PreprocessConfig(2, 1, 1, time_delta=time_delta),
                             **kw)
    _write(tmp_path, text)
    got = tds.load_raw(spec_t, tmp_path)
    with monkeypatch.context() as m:
        m.setattr(native, "parse_edges", tds.parse_edges_numpy)
        _same_raw(got, tds.load_raw(spec_t, tmp_path))
    _need_jax_native()
    _same_raw(got, jds.load_raw(spec_j, tmp_path))


def _same_raw(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


REGISTRY_FILES = {
    "bitcoin_otc": SYNTHETIC / "bitcoin_otc",
    "reddit": SYNTHETIC / "reddit",
    "amlsim": SYNTHETIC / "amlsim",
    "uci": SYNTHETIC / "uci",
    "chess": ROOT / "data" / "chess",
}


@pytest.mark.parametrize("name", list(REGISTRY_FILES))
def test_parse_registry_formats(name):
    """Each registry format's file: the selected columns of np.loadtxt and
    of the JAX package's parser."""
    spec = tds.REGISTRY[name]
    path = REGISTRY_FILES[name] / spec.filename
    args = (spec.columns, spec.delimiter, spec.skiprows, spec.comments)
    got = native.parse_edges(path, *args)
    _same([got], [tds.parse_edges_numpy(path, *args)])
    _need_jax_native()
    _same([got], [jnative.parse_edges(path, list(spec.columns), spec.delimiter, spec.skiprows,
                                      spec.comments)])


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_edges(tmp_path / "absent.csv", (0, 1), ",", 0, "#")


# ------------------------------------------------------------------ build

_BUILD = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from tmgcn_torch.native import build
import ctypes
path = build.build(Path(sys.argv[1]))
ctypes.CDLL(str(path)).tmgcn_pack_count
print(path)
"""


def test_concurrent_first_build(tmp_path):
    """Two processes build into the same empty directory at once: both load
    a whole library at the one path, and no temporary file is left."""
    code = _BUILD.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert paths == {str(nbuild.library_path(tmp_path))}
    assert [p.name for p in tmp_path.iterdir()] == [Path(paths.pop()).name]


@pytest.mark.parametrize("compiler", ["false", "/nonexistent/g++"])
def test_failed_build_raises_with_the_command(tmp_path, monkeypatch, compiler):
    monkeypatch.setenv("CXX", compiler)
    with pytest.raises(RuntimeError, match="native runtime build failed") as err:
        nbuild.build(tmp_path)
    assert compiler in str(err.value) and "tmgcn_native.cpp" in str(err.value)
    assert list(tmp_path.iterdir()) == []


def test_no_fallback_when_the_runtime_fails(monkeypatch, tmp_path):
    """load_raw, the sampler and the packer raise with the runtime's error;
    nothing carries on in numpy."""
    def broken():
        raise RuntimeError("native runtime build failed: g++ ...")

    monkeypatch.setattr(native, "load", broken)
    spec = tds.REGISTRY["uci"]
    with pytest.raises(RuntimeError, match="build failed"):
        tds.load_raw(spec, SYNTHETIC / "uci")
    with pytest.raises(RuntimeError, match="build failed"):
        ts.augment_edges(np.array([[0], [1], [2]]), 5, 1, 1, 1)
    with pytest.raises(RuntimeError, match="build failed"):
        tk.pack_windowed_flat(np.array([1]), np.array([0]), np.ones(1, np.float32), 8)
    args = (spec.columns, spec.delimiter, spec.skiprows, spec.comments)
    assert len(tds.parse_edges_numpy(SYNTHETIC / "uci" / spec.filename, *args)) > 0
