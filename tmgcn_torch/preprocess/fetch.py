"""Real-dataset acquisition: URL + checksum manifest and a fetcher (port of
tmgcn_tpu.preprocess.fetch, kept as its own copy: the port imports nothing
of the JAX package).

The reference's external datasets come from SNAP and KONECT
(read_data.m:13-103 names every file). The repo ships seeded synthetic
stand-ins (preprocess/synthetic_raw.py); this module is the one-command
path to the real files on a machine with network access:

    python -m tmgcn_torch.cli fetch bitcoin_otc
    python -m tmgcn_torch.cli fetch all --data-root data/real

Each entry records the canonical URL, the archive member that becomes
the ``DatasetSpec.filename`` the preprocessing pipeline expects, and a
sha256. Hashes marked ``None`` are not pinned yet: the first successful
fetch records the downloaded file's hash into ``data/MANIFEST.lock.json``
(the same file the JAX package's fetcher pins into, so both packages
hold the same hashes) and every later fetch validates against it
(trust-on-first-use, flagged in the output so a user can cross-check the
published checksums).
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import json
import os
import shutil
import tarfile
from pathlib import Path

from tmgcn_torch.preprocess.datasets import REGISTRY, load_raw


@dataclasses.dataclass(frozen=True)
class FetchSpec:
    url: str
    kind: str  # "plain" | "gz" | "tar.bz2"
    member: str | None = None  # member path inside a tar archive
    sha256: str | None = None  # None -> pin on first fetch
    note: str | None = None
    manual: bool = False  # no canonical download; user generates/places the file


MANIFEST: dict[str, FetchSpec] = {
    # SNAP (read_data.m:14,22: soc-sign-bitcoin*.csv)
    "bitcoin_otc": FetchSpec(
        "https://snap.stanford.edu/data/soc-sign-bitcoinotc.csv.gz", "gz"
    ),
    "bitcoin_alpha": FetchSpec(
        "https://snap.stanford.edu/data/soc-sign-bitcoinalpha.csv.gz", "gz"
    ),
    # SNAP (read_data.m:18-24 config block "Reddit")
    "reddit": FetchSpec(
        "https://snap.stanford.edu/data/soc-redditHyperlinks-body.tsv", "plain"
    ),
    # KONECT (read_data.m:26-32; data/chess ships in-repo — fetch is a
    # re-validation path)
    "chess": FetchSpec(
        "http://konect.cc/files/download.tsv.chess.tar.bz2",
        "tar.bz2", member="chess/out.chess",
    ),
    # KONECT (read_data.m:34: out.ca-cit-HepTh)
    "hep_th": FetchSpec(
        "http://konect.cc/files/download.tsv.ca-cit-HepTh.tar.bz2",
        "tar.bz2", member="ca-cit-HepTh/out.ca-cit-HepTh",
    ),
    # KONECT (read_data.m:42: out.wikiconflict)
    "wikiconflict": FetchSpec(
        "http://konect.cc/files/download.tsv.wikiconflict.tar.bz2",
        "tar.bz2", member="wikiconflict/out.wikiconflict",
    ),
    # Opsahl's UCI online community messages (read_data.m:59:
    # OCnodeslinks.txt)
    "uci": FetchSpec(
        "http://opsahl.co.uk/tnet/datasets/OCnodeslinks.txt", "plain"
    ),
    # SNAP (read_data.m:77: email-Eu-core-temporal.txt)
    "eu_core": FetchSpec(
        "https://snap.stanford.edu/data/email-Eu-core-temporal.txt.gz", "gz"
    ),
    # AMLSim has no stable download: the reference consumed the
    # 1Kvertices-100Kedges run of IBM's simulator (read_data.m:50).
    "amlsim": FetchSpec(
        "https://github.com/IBM/AMLSim", "plain", manual=True,
        note=(
            "No canonical file: generate transactions.csv with IBM "
            "AMLSim (1Kvertices-100Kedges config) and place it at "
            "<data-root>/amlsim/transactions.csv"
        ),
    ),
}

# Published dataset statistics (the KONECT/SNAP pages cited by
# read_data.m:13-103), as (lo, hi) acceptance ranges. A trust-on-first-
# use pin is only recorded when the parsed file's row/node counts land
# inside these — a truncated or substituted first download is rejected
# BEFORE its hash can become canonical. Ranges are deliberately wide
# (hosting sites occasionally re-export with small diffs); they exist
# to catch gross truncation/poisoning, not byte drift.
EXPECTED_STATS: dict[str, dict[str, tuple[int, int]]] = {
    "bitcoin_otc": {"rows": (33_000, 38_000), "nodes": (5_500, 6_300)},
    "bitcoin_alpha": {"rows": (22_000, 26_500), "nodes": (3_400, 4_200)},
    "reddit": {"rows": (260_000, 310_000), "nodes": (25_000, 50_000)},
    "chess": {"rows": (62_000, 68_000), "nodes": (6_900, 7_700)},
    "hep_th": {"rows": (2_100_000, 3_300_000), "nodes": (18_000, 28_000)},
    "wikiconflict": {"rows": (2_300_000, 3_500_000),
                     "nodes": (90_000, 140_000)},
    "uci": {"rows": (55_000, 65_000), "nodes": (1_700, 2_100)},
    "eu_core": {"rows": (300_000, 360_000), "nodes": (850, 1_100)},
}


def validate_stats(name: str, raw) -> None:
    """Reject a parsed raw file whose row/node counts fall outside the
    published ranges (EXPECTED_STATS). Called before hash pinning."""
    stats = EXPECTED_STATS.get(name)
    if stats is None:
        return
    n_rows = int(len(raw.src))
    n_nodes = int(raw.n_nodes)
    for label, value in (("rows", n_rows), ("nodes", n_nodes)):
        lo, hi = stats[label]
        if not (lo <= value <= hi):
            raise RuntimeError(
                f"{name}: statistics mismatch — {label}={value} outside the "
                f"published range [{lo}, {hi}] (read_data.m:13-103 sources); "
                "refusing to accept/pin this file"
            )


LOCK_PATH = Path(__file__).resolve().parents[2] / "data" / "MANIFEST.lock.json"


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _load_lock() -> dict:
    try:
        return json.loads(LOCK_PATH.read_text())
    except (OSError, ValueError):
        return {}


def _save_lock(lock: dict) -> None:
    LOCK_PATH.parent.mkdir(parents=True, exist_ok=True)
    LOCK_PATH.write_text(json.dumps(lock, indent=1, sort_keys=True))


def fetch(name: str, data_root: str | Path = "data/real",
          timeout: float = 120.0) -> Path:
    """Download + extract + validate dataset ``name``.

    Returns the path of the raw file at the location
    ``load_raw``/``cli preprocess`` expect (<data_root>/<name>/<filename>).
    """
    import urllib.request

    spec = REGISTRY[name]
    f = MANIFEST[name]
    if f.manual:
        raise RuntimeError(f.note or f"{name}: manual acquisition only")
    dest_dir = Path(data_root) / name
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / spec.filename
    if dest.exists():
        print(f"{name}: {dest} already present")
    else:
        tmp = dest_dir / (spec.filename + ".download")
        # Extract into a second temp and os.replace only on success: a
        # crash mid-extraction must never leave a partial file at
        # ``dest`` (it would read as "already present" and poison the
        # trust-on-first-use hash pin below).
        extracted = dest_dir / (spec.filename + ".extract")
        print(f"{name}: fetching {f.url}")
        with urllib.request.urlopen(f.url, timeout=timeout) as r, open(
            tmp, "wb"
        ) as out:
            shutil.copyfileobj(r, out)
        if f.kind == "gz":
            with gzip.open(tmp, "rb") as src, open(extracted, "wb") as out:
                shutil.copyfileobj(src, out)
            tmp.unlink()
        elif f.kind == "tar.bz2":
            with tarfile.open(tmp, "r:bz2") as tar:
                member = tar.extractfile(f.member)
                if member is None:
                    raise FileNotFoundError(f"{f.member} not in archive")
                with open(extracted, "wb") as out:
                    shutil.copyfileobj(member, out)
            tmp.unlink()
        else:
            tmp.rename(extracted)
        os.replace(extracted, dest)

    digest = _sha256(dest)
    lock = _load_lock()
    expected = f.sha256 or lock.get(name, {}).get("sha256")
    if expected is not None and digest != expected:
        raise RuntimeError(
            f"{name}: sha256 mismatch — expected {expected}, got {digest}"
        )

    # Validate shape AND statistics BEFORE pinning: the file must parse
    # under the DatasetSpec and its row/node counts must land in the
    # published ranges, so a corrupt, truncated, or substituted download
    # never gets its hash recorded as canonical.
    raw = load_raw(spec, dest_dir)
    try:
        validate_stats(name, raw)
    except RuntimeError:
        # Leave nothing behind that would read as "already present".
        dest.unlink(missing_ok=True)
        raise
    print(f"{name}: parsed ok ({raw.n_slices} slices, {raw.n_nodes} nodes, "
          f"{len(raw.src)} rows)")

    if expected is None:
        lock[name] = {"sha256": digest, "url": f.url, "pinned": "first-fetch"}
        _save_lock(lock)
        print(f"{name}: sha256 {digest} PINNED (trust-on-first-use; "
              "cross-check against the published checksum)")
    else:
        print(f"{name}: sha256 ok ({digest[:16]}…)")
    return dest


def fetch_all(data_root: str | Path = "data/real") -> dict[str, str]:
    out = {}
    for name, spec in MANIFEST.items():
        if spec.manual:
            # Not a failure: there is nothing to download (e.g. amlsim
            # is simulator-generated). Report the instructions.
            out[name] = f"SKIPPED (manual): {spec.note}"
            print(f"{name}: skipped — {spec.note}")
            continue
        try:
            out[name] = str(fetch(name, data_root))
        except Exception as e:  # keep going; report at the end
            out[name] = f"FAILED: {e}"
            print(f"{name}: {e}")
    return out
