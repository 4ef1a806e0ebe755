"""The port's ``synth``, ``preprocess`` and ``fetch`` (preprocess/
synthetic_raw.py, preprocess/fetch.py and their CLI commands) against the
JAX package's, on the CPU.

* ``synth``: for all eight names at seeds 0 and 3 the raw file's bytes are
  the JAX generator's; the port's ``load_raw`` of each equals the JAX
  ``load_raw`` array for array (and wikiconflict's column-sum filter
  keeps the same nodes); ``cli synth`` writes the JAX ``cli synth``'s
  files.
* ``preprocess``: the artifact that the port's ``cli preprocess uci``
  writes loads back array for array equal to the JAX CLI's (scipy stamps
  the creation time into the .mat header, so the bytes differ).
* ``fetch``: tests/test_fetch.py's six cases on the port's fetcher, with
  archives served from ``file://`` URLs built in the test and ``MANIFEST``
  and ``LOCK_PATH`` patched into the test's directory (nothing is
  downloaded, no repo file is written); the port's ``MANIFEST``,
  ``EXPECTED_STATS`` and ``LOCK_PATH`` are the JAX package's.
"""

import dataclasses
import gzip
import json
import shutil

import numpy as np
import pytest
import scipy.io

from tmgcn_tpu import cli as jcli
from tmgcn_tpu.preprocess import datasets as jdatasets
from tmgcn_tpu.preprocess import fetch as JF
from tmgcn_tpu.preprocess import pipeline as jpipeline
from tmgcn_tpu.preprocess import synthetic_raw as jsynth
from tmgcn_torch import cli
from tmgcn_torch.preprocess import datasets as tdatasets
from tmgcn_torch.preprocess import fetch as F
from tmgcn_torch.preprocess import pipeline as tpipeline
from tmgcn_torch.preprocess import synthetic_raw as tsynth


def _assert_raw_equal(got, ref):
    for f in ("src", "dst", "weight", "slice_id"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.n_nodes, got.n_slices) == (ref.n_nodes, ref.n_slices)


def test_the_same_synthetic_specs():
    assert tsynth.SYNTH.keys() == jsynth.SYNTH.keys()
    assert len(tsynth.SYNTH) == 8
    for name, spec in tsynth.SYNTH.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(jsynth.SYNTH[name])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(jsynth.SYNTH))
def test_synth_writes_the_jax_bytes_and_loads_the_same(tmp_path, name, seed):
    got = tsynth.generate(name, tmp_path / "port", seed=seed)
    ref = jsynth.generate(name, tmp_path / "jax", seed=seed)
    assert got.name == ref.name == tdatasets.REGISTRY[name].filename
    assert got.read_bytes() == ref.read_bytes()
    raw_t = tdatasets.load_raw(tdatasets.REGISTRY[name], got.parent)
    raw_j = jdatasets.load_raw(jdatasets.REGISTRY[name], ref.parent)
    _assert_raw_equal(raw_t, raw_j)
    if name == "wikiconflict":
        # The column-sum >= 100 node filter (read_data.m:154-170) bites, and
        # keeps the same nodes on both sides.
        m = tdatasets.REGISTRY[name].preprocess.min_column_sum
        kept_t = tpipeline.filter_nodes_by_column_sum(raw_t, m)
        kept_j = jpipeline.filter_nodes_by_column_sum(raw_j, m)
        assert kept_t.n_nodes < raw_t.n_nodes
        _assert_raw_equal(kept_t, kept_j)


def test_cli_synth_writes_the_jax_files(tmp_path):
    assert cli.main(["synth", "--out", str(tmp_path / "port"), "--seed", "3"]) == 0
    assert jcli.main(["synth", "--out", str(tmp_path / "jax"), "--seed", "3"]) == 0
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*"))
    ref = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*"))
    assert got == ref and len([p for p in got if p.suffix]) == 8
    for rel in got:
        if (tmp_path / "port" / rel).is_file():
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    # One dataset alone, and generate_all, write the same files.
    assert cli.main(["synth", "--dataset", "uci", "--out", str(tmp_path / "one")]) == 0
    paths = tsynth.generate_all(tmp_path / "all", seed=0)
    assert (tmp_path / "one" / "uci" / "OCnodeslinks.txt").read_bytes() == \
        paths["uci"].read_bytes()


def test_cli_preprocess_writes_the_jax_artifact(tmp_path):
    raw = tsynth.generate("uci", tmp_path / "raw", seed=0)
    # The port makes a missing --out directory; the JAX CLI needs it made.
    assert cli.main(["preprocess", "uci", "--data-dir", str(raw.parent),
                     "--out", str(tmp_path / "port")]) == 0
    (tmp_path / "jax").mkdir()
    assert jcli.main(["preprocess", "uci", "--data-dir", str(raw.parent),
                      "--out", str(tmp_path / "jax")]) == 0
    name = "saved_content_uci.mat"
    got = scipy.io.loadmat(tmp_path / "port" / name)
    ref = scipy.io.loadmat(tmp_path / "jax" / name)
    keys = {k for k in ref if not k.startswith("__")}
    assert keys and {k for k in got if not k.startswith("__")} == keys
    for k in sorted(keys):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # Without --out the artifact lands beside the raw file.
    assert cli.main(["preprocess", "uci", "--data-dir", str(raw.parent)]) == 0
    assert (raw.parent / name).exists()


# ---------------------------------------------------------------- fetch


def test_manifest_and_stats_are_the_jax_packages():
    assert F.MANIFEST.keys() == JF.MANIFEST.keys()
    for name, spec in F.MANIFEST.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(JF.MANIFEST[name]), name
    assert F.EXPECTED_STATS == JF.EXPECTED_STATS
    # Both packages pin into the same lock file.
    assert F.LOCK_PATH == JF.LOCK_PATH
    assert F.LOCK_PATH.parent.name == "data"


@pytest.fixture()
def manifest_env(tmp_path, monkeypatch):
    """A local 'remote': the bitcoin_otc synthetic raw, gzipped."""
    src_dir = tmp_path / "remote"
    raw = tsynth.generate("bitcoin_otc", src_dir, seed=0)
    gz = src_dir / "soc-sign-bitcoinotc.csv.gz"
    with open(raw, "rb") as f_in, gzip.open(gz, "wb") as f_out:
        f_out.write(f_in.read())
    monkeypatch.setattr(F, "MANIFEST", {"bitcoin_otc": F.FetchSpec(gz.as_uri(), "gz")})
    monkeypatch.setattr(F, "LOCK_PATH", tmp_path / "MANIFEST.lock.json")
    # The synthetic stand-in is smaller than the real dataset: the
    # published-statistics gate scaled to it (the gate itself is held by
    # test_fetch_rejects_wrong_statistics).
    monkeypatch.setitem(F.EXPECTED_STATS, "bitcoin_otc",
                        {"rows": (20_000, 28_000), "nodes": (600, 1_000)})
    return tmp_path, raw


def test_fetch_extracts_validates_and_pins(manifest_env):
    tmp_path, raw = manifest_env
    dest = F.fetch("bitcoin_otc", tmp_path / "real")
    assert dest.exists()
    assert dest.read_bytes() == raw.read_bytes()
    lock = json.loads((tmp_path / "MANIFEST.lock.json").read_text())
    assert lock["bitcoin_otc"]["sha256"] == F._sha256(dest)
    # A second fetch validates against the pinned hash; so does the CLI.
    F.fetch("bitcoin_otc", tmp_path / "real")
    assert cli.main(["fetch", "bitcoin_otc", "--data-root", str(tmp_path / "real")]) == 0


def test_fetch_rejects_hash_mismatch(manifest_env):
    tmp_path, _ = manifest_env
    dest = F.fetch("bitcoin_otc", tmp_path / "real")
    with open(dest, "ab") as f:
        f.write(b"tampered\n")
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        F.fetch("bitcoin_otc", tmp_path / "real")


def test_fetch_rejects_wrong_statistics(manifest_env, monkeypatch):
    """A truncated or substituted first download is refused before its hash
    is pinned: the served file parses but its row count misses the range."""
    tmp_path, _ = manifest_env
    monkeypatch.setitem(F.EXPECTED_STATS, "bitcoin_otc",
                        {"rows": (33_000, 38_000), "nodes": (5_500, 6_300)})
    with pytest.raises(RuntimeError, match="statistics mismatch"):
        F.fetch("bitcoin_otc", tmp_path / "real")
    assert not (tmp_path / "MANIFEST.lock.json").exists()
    assert not (tmp_path / "real/bitcoin_otc/soc-sign-bitcoinotc.csv").exists()
    # fetch all reports the failure and exits 1; a manual entry is skipped.
    monkeypatch.setitem(F.MANIFEST, "amlsim", JF.MANIFEST["amlsim"])
    res = F.fetch_all(tmp_path / "real")
    assert res["bitcoin_otc"].startswith("FAILED") and res["amlsim"].startswith("SKIPPED")
    assert cli.main(["fetch", "all", "--data-root", str(tmp_path / "real")]) == 1


def test_every_fetchable_dataset_has_stats():
    for name, spec in F.MANIFEST.items():
        if not spec.manual:
            assert name in F.EXPECTED_STATS, name


def test_manifest_covers_every_external_dataset():
    external = set(tdatasets.REGISTRY) - {"chess"}  # chess ships in the repo (also listed)
    assert external <= set(F.MANIFEST)
    for name, spec in F.MANIFEST.items():
        assert spec.url.startswith("http")
        if spec.kind == "tar.bz2":
            assert spec.member


def test_partial_extraction_cannot_poison_pin(manifest_env, monkeypatch):
    """A crash mid-extraction leaves no file at dest (temp + os.replace),
    and a corrupt but complete file fails parsing before its hash is
    pinned."""
    tmp_path, _ = manifest_env
    calls = {"n": 0}
    real = shutil.copyfileobj

    def flaky(src, dst, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:  # the first call downloads, the second extracts
            raise OSError("simulated truncation")
        return real(src, dst, *a, **k)

    monkeypatch.setattr(F.shutil, "copyfileobj", flaky)
    with pytest.raises(OSError):
        F.fetch("bitcoin_otc", tmp_path / "real")
    monkeypatch.setattr(F.shutil, "copyfileobj", real)

    dest = tmp_path / "real/bitcoin_otc/soc-sign-bitcoinotc.csv"
    assert not dest.exists()
    assert not (tmp_path / "MANIFEST.lock.json").exists()

    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text("not,a,valid\nedge,list,at,all\n")
    with pytest.raises(Exception):
        F.fetch("bitcoin_otc", tmp_path / "real")
    assert "bitcoin_otc" not in F._load_lock()
