"""Synthetic raw-file generators shaped per DatasetSpec (port of
tmgcn_tpu.preprocess.synthetic_raw, kept as its own copy: the port imports
nothing of the JAX package).

The reference's eight external datasets (KONECT/SNAP downloads —
read_data.m:13-103) are not in the repo. These generators write raw files
with the exact column layout, delimiter, header and timestamp conventions
each ``DatasetSpec`` expects, so the preprocessing and every preset run
end to end on them. For the same name and seed the files are byte for
byte the JAX package's: the same numpy draws in the same order, and the
same text.

Graphs are seeded dynamic community graphs: each node gets one of two
communities; edge endpoints are drawn with power-law-ish node
popularity; the edge weight's sign correlates with community agreement
(intra = mostly positive) so sign-classification tasks are learnable,
not pure noise. Timestamps cover every slice of the dataset's canonical
window layout.
"""

from __future__ import annotations

import dataclasses
import zlib
from pathlib import Path

import numpy as np

from tmgcn_torch.preprocess.datasets import REGISTRY, DatasetSpec


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    n_nodes: int
    n_edges: int
    n_slices: int  # distinct time bins to cover


# Sized so the canonical split (s_train + s_val + s_test) is covered and
# a preset smoke run finishes in seconds.
SYNTH: dict[str, SynthSpec] = {
    "bitcoin_otc": SynthSpec(800, 24_000, 135),
    "bitcoin_alpha": SynthSpec(700, 20_000, 135),
    "reddit": SynthSpec(600, 20_000, 86),
    "amlsim": SynthSpec(1000, 30_000, 200),
    "uci": SynthSpec(500, 15_000, 88),
    "eu_core": SynthSpec(400, 12_000, 133),
    "hep_th": SynthSpec(600, 20_000, 195),
    "wikiconflict": SynthSpec(500, 25_000, 89),
}


def _draw_edges(rng, n_nodes, n_edges):
    """Power-law-ish endpoints + community-correlated sign."""
    comm = rng.integers(0, 2, n_nodes)
    pop = (rng.pareto(1.5, n_nodes) + 1.0)
    p = pop / pop.sum()
    src = rng.choice(n_nodes, n_edges, p=p)
    dst = rng.choice(n_nodes, n_edges, p=p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    agree = comm[src] == comm[dst]
    # Majority-positive like the real signed networks (~78% positive
    # here, ~90% on bitcoin), with community agreement predictive of
    # sign so the classification task is learnable.
    r = rng.random(len(src))
    pos = np.where(agree, r < 0.95, r < 0.6)
    return src, dst, pos


def _timestamps(rng, n, n_slices, delta, t0=1.3e9):
    """Uniform timestamps guaranteed to touch every slice.

    bin_edges truncates to floor((max - min) / delta) full bins, so pin
    min to t0 exactly and park one sentinel edge past the last bin
    boundary — every one of the n_slices bins then survives.
    """
    ts = t0 + rng.integers(0, n_slices, n) * delta + rng.random(n) * delta * 0.9
    # Ensure each slice has at least one edge.
    ts[:n_slices] = t0 + (np.arange(n_slices) + 0.5) * delta
    ts[0] = t0
    ts[n_slices] = t0 + (n_slices + 0.01) * delta  # dropped by binning
    return ts


def generate(name: str, data_dir: str | Path, seed: int = 0) -> Path:
    """Write dataset ``name``'s synthetic raw file; returns its path."""
    spec: DatasetSpec = REGISTRY[name]
    s = SYNTH[name]
    # Per-name salt must be stable ACROSS processes (Python's str hash
    # is randomized per interpreter), or the committed raw files could
    # never be regenerated from the seed.
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
    out_dir = Path(data_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / spec.filename

    src, dst, pos = _draw_edges(rng, s.n_nodes, s.n_edges)
    n = len(src)

    if name in ("bitcoin_otc", "bitcoin_alpha"):
        # KONECT soc-sign-bitcoin*: "src,dst,rating,unix_ts", 1-based
        # nodes, rating in [-10, 10] \ {0}  (read_data.m:13-28).
        rating = np.where(pos, rng.integers(1, 11, n), -rng.integers(1, 11, n))
        ts = _timestamps(rng, n, s.n_slices, spec.preprocess.time_delta)
        lines = [
            f"{a + 1},{b + 1},{r},{int(t)}"
            for a, b, r, t in zip(src, dst, rating, ts)
        ]
        path.write_text("\n".join(lines) + "\n")
    elif name == "reddit":
        # SNAP soc-redditHyperlinks-body.tsv: header + tab columns
        # (SOURCE, TARGET, POST_ID, TIMESTAMP, SENTIMENT, ...); the spec
        # reads cols (0,1,4,3). Numeric stand-ins for the string ids.
        sent = np.where(pos, 1, -1)
        ts = _timestamps(rng, n, s.n_slices, spec.preprocess.time_delta)
        header = "SOURCE\tTARGET\tPOST_ID\tTIMESTAMP\tLINK_SENTIMENT\tPROPERTIES"
        lines = [header] + [
            f"{a + 1}\t{b + 1}\t{i}\t{int(t)}\t{v}\t0"
            for i, (a, b, t, v) in enumerate(zip(src, dst, ts, sent))
        ]
        path.write_text("\n".join(lines) + "\n")
    elif name == "amlsim":
        # AMLSim transactions.csv: header; cols (1,2,7,5) = sender,
        # receiver, fraud flag, step  (full_read_data.py:49-57).
        #
        # Label encoding: the reference's experiment script computes
        # target = (sign(label) != -1) (experiment_amlsim_our.py:77-78),
        # so a real {0,1} is_sar column makes EVERY edge class 1 and the
        # task vacuous (both frameworks drive loss to ~0 with NaN F1).
        # The synthetic stand-in therefore writes
        # fraud as -1 and normal as +1, giving the script's own
        # convention a genuine ~3% minority class.
        #
        # Labels are topology-correlated but NOISY (controlled Bayes
        # error): a 3% launderer set frauds with
        # p=0.7 inside the clique, p=0.15 on half-clique edges, p=0.01
        # in the background — learnable, not trivially separable.
        launderer = rng.random(s.n_nodes) < 0.03
        n_laund = launderer[src].astype(int) + launderer[dst].astype(int)
        p_fraud = np.choose(n_laund, [0.01, 0.15, 0.7])
        fraud = rng.random(n) < p_fraud
        flag = np.where(fraud, -1, 1)
        step = rng.integers(0, s.n_slices, n)
        step[: s.n_slices] = np.arange(s.n_slices)
        amount = np.round(rng.lognormal(4.0, 1.0, n), 2)
        header = (
            "tran_id,orig_acct,bene_acct,tx_type,base_amt,tran_timestamp,"
            "alert_id,is_sar"
        )
        lines = [header] + [
            f"{i},{a + 1},{b + 1},0,{amt},{t},-1,{int(f)}"
            for i, (a, b, amt, t, f) in enumerate(zip(src, dst, amount, step, flag))
        ]
        path.write_text("\n".join(lines) + "\n")
    elif name == "uci":
        # OCnodeslinks.txt: whitespace "datenum src dst chars"; the spec
        # reads cols (1,2,3,0) with time_delta=1 on normalized datenums
        # (read_data.m:77-87).
        ts = rng.integers(0, s.n_slices, n) + rng.random(n) * 0.9
        ts[: s.n_slices] = np.arange(s.n_slices) + 0.5
        ts[0] = 0.0
        ts[s.n_slices] = s.n_slices + 0.01  # sentinel past the last bin
        chars = rng.integers(1, 500, n)
        lines = [
            f"{t:.4f} {a + 1} {b + 1} {c}"
            for t, a, b, c in zip(ts, src, dst, chars)
        ]
        path.write_text("\n".join(lines) + "\n")
    elif name in ("eu_core",):
        # email-Eu-core-temporal.txt: "src dst ts", 0-based, seconds.
        ts = _timestamps(rng, n, s.n_slices, spec.preprocess.time_delta, t0=0)
        lines = [f"{a} {b} {int(t)}" for a, b, t in zip(src, dst, ts)]
        path.write_text("\n".join(lines) + "\n")
    elif name in ("hep_th", "wikiconflict"):
        # KONECT format: "% header" line then "src dst weight ts".
        if name == "wikiconflict":
            # Weights must push some nodes past the column-sum >= 100
            # filter (read_data.m:154-170).
            w = np.where(pos, 1, -1) * rng.integers(1, 11, n)
        else:
            w = np.ones(n, dtype=int)
        ts = _timestamps(rng, n, s.n_slices, spec.preprocess.time_delta)
        lines = ["% sym unweighted"] + [
            f"{a + 1} {b + 1} {v} {int(t)}" for a, b, v, t in zip(src, dst, w, ts)
        ]
        path.write_text("\n".join(lines) + "\n")
    else:
        raise KeyError(f"no synthetic generator for {name!r}")
    return path


def generate_all(base_dir: str | Path, seed: int = 0) -> dict[str, Path]:
    """Generate every synthetic dataset under base_dir/<name>/."""
    return {
        name: generate(name, Path(base_dir) / name, seed=seed) for name in SYNTH
    }
