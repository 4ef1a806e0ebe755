"""The port's span recorder (``utils/profiling``: ``span``, ``recording``,
``records``, ``summary``) and the spans the program opens, on the CPU.

Off, a span records nothing and opens no profiler range, and still times
itself; on, its record has its name, parent, trial id, attributes and
self time, and under ``torch.profiler`` it is a host range of the same
name. A tiny edge-classification run with the recorder on opens the set-up
and loop spans the loop's docstring lists. ``phase_events`` needs a card;
``profile_slice.step_phases`` reads them (here from a stand-in runner).
"""

import dataclasses
import functools
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tmgcn_torch.configs import build
from tmgcn_torch.configs.presets import get_preset
from tmgcn_torch.tasks import adapters
from tmgcn_torch.train import loop
from tmgcn_torch.utils import profile_slice, profiling
from tmgcn_torch.utils.profiling import recording, records, span, summary

SLEEP_S = 0.002


def _host_events(prof) -> dict[str, list]:
    out: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name, []).append(e)
    return out


@pytest.mark.parametrize("sync", [False, True])
def test_off_records_nothing_opens_no_range_and_still_times(sync):
    recording(False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("test.outer", sync=sync, k=1) as s:
            with span("test.inner") as inner:
                time.sleep(SLEEP_S)
            s.set(n=3)
    assert not {"test.outer", "test.inner"} & {r["name"] for r in records()}
    assert not {"test.outer", "test.inner"} & set(_host_events(prof))
    assert s.seconds >= inner.seconds >= SLEEP_S
    assert s.attrs == {"k": 1}  # set() does nothing off


def _nested():
    """Two trials, each with an evaluation holding a forward, and a span
    outside any trial; sleeps give each span some self time."""
    with span(profiling.TRIAL):
        with span("loop.eval", epoch=0):
            time.sleep(SLEEP_S)
            with span("loop.eval.forward", window="val") as f:
                time.sleep(SLEEP_S)
                f.set(rows=7)
        with span("loop.steps", n=4):
            time.sleep(SLEEP_S)
    with span(profiling.TRIAL):
        with span("loop.steps", n=5, trial=99):  # an explicit id is kept
            time.sleep(SLEEP_S)
    with span("setup.data"):
        time.sleep(SLEEP_S)


@pytest.mark.parametrize("as_context", [True, False])
def test_on_records_names_parents_trials_attrs_and_self_time(as_context):
    if as_context:
        with recording():
            _nested()
    else:
        recording()
        try:
            _nested()
        finally:
            recording(False)
    with span("after.off"):
        pass
    recs = records()
    assert [r["name"] for r in recs] == ["loop.trial", "loop.eval", "loop.eval.forward",
                                         "loop.steps", "loop.trial", "loop.steps", "setup.data"]
    by_id = {r["id"]: r for r in recs}
    parent = [by_id[r["parent"]]["name"] if r["parent"] is not None else None for r in recs]
    assert parent == [None, "loop.trial", "loop.eval", "loop.trial", None, "loop.trial", None]
    assert [r["attrs"].get("trial") for r in recs] == [0, 0, 0, 0, 1, 99, None]
    assert recs[1]["attrs"] == {"epoch": 0, "trial": 0}
    assert recs[2]["attrs"] == {"window": "val", "rows": 7, "trial": 0}
    assert recs[3]["attrs"]["n"] == 4
    for r in recs:
        assert r["end_ns"] - r["start_ns"] >= SLEEP_S * 1e9
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
    s = summary()
    assert s["loop.steps"]["count"] == 2 and s["loop.trial"]["count"] == 2
    ev, fw = recs[1], recs[2]
    want_self = (ev["end_ns"] - ev["start_ns"] - (fw["end_ns"] - fw["start_ns"])) / 1e9
    assert s["loop.eval"]["self_s"] == pytest.approx(want_self, abs=1e-12)
    assert s["loop.eval"]["self_s"] >= SLEEP_S
    assert s["loop.eval.forward"]["self_s"] == s["loop.eval.forward"]["total_s"]
    trial0 = recs[0]
    children = sum(r["end_ns"] - r["start_ns"] for r in recs if r["parent"] == trial0["id"])
    assert summary(recs[:1] + recs[1:4])["loop.trial"]["self_s"] == pytest.approx(
        (trial0["end_ns"] - trial0["start_ns"] - children) / 1e9, abs=1e-12)
    assert s["setup.data"]["median_ms"] == pytest.approx(
        (recs[6]["end_ns"] - recs[6]["start_ns"]) / 1e6)


def test_recording_switch_restores_and_starts_anew():
    with recording():
        with span("a"):
            pass
        with recording():  # already on: the same recording goes on
            with span("b"):
                pass
        with recording(False):
            with span("c"):
                pass
        with span("d"):
            pass
    assert [r["name"] for r in records()] == ["a", "b", "d"]
    with recording():
        with span("e"):
            pass
    assert [r["name"] for r in records()] == ["e"]


def test_spans_are_profiler_ranges_on_the_same_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with recording():
            _nested()
    host = _host_events(prof)
    recs = records()
    by_id = {r["id"]: r for r in recs}
    for name in {r["name"] for r in recs}:
        ours = sorted((r for r in recs if r["name"] == name), key=lambda r: r["start_ns"])
        theirs = sorted(host[name], key=lambda e: e.time_range.start)
        assert len(ours) == len(theirs)
        for r, e in zip(ours, theirs):
            # Its duration agrees with the record within 1 ms.
            assert abs((e.time_range.end - e.time_range.start) / 1e3
                       - (r["end_ns"] - r["start_ns"]) / 1e6) < 1.0
            r["range"] = (e.time_range.start, e.time_range.end)
    for r in recs:  # each range holds its children's
        if r["parent"] is not None:
            lo, hi = by_id[r["parent"]]["range"]
            assert lo <= r["range"][0] and r["range"][1] <= hi


def _konect(d, n_nodes=40, n_slices=100, per_slice=8, seed=0):
    """A chess-format edge file: a header, then `src dst result<TAB>time`."""
    rng = np.random.default_rng(seed)
    lines = ["% asym multisigned"]
    for t in range(n_slices):
        for _ in range(per_slice):
            s, dd = rng.choice(n_nodes, 2, replace=False) + 1
            lines.append(f"{s} {dd} {rng.integers(-1, 2)}\t{1000.5 + t}")
    d.mkdir(parents=True, exist_ok=True)
    (d / "out.chess.csv").write_text("\n".join(lines) + "\n")
    return d


LAYER2 = {"adapter.bundles", "adapter.propagate", "adapter.layer2"}


@pytest.mark.parametrize("preset,impl,stream,adapter_spans,operator", [
    ("chess_tmgcn2_cls", None, None, LAYER2, "rowsplit"),
    # The streamed layer 2 packs K1 whatever operator is asked for (in its
    # bf16 tier for a bf16 impl), and its span names the K1 it built.
    ("chess_tmgcn2_cls", None, 2, LAYER2, "pallas"),
    ("chess_tmgcn2_cls", "pallas_bf16", 2, LAYER2, "pallas_bf16"),
    ("chess_wdgcn_cls", None, None, {"adapter.bundles", "adapter.propagate"}, None),
])
def test_edge_classification_run_opens_the_loop_spans(tmp_path, monkeypatch, preset, impl,
                                                      stream, adapter_spans, operator):
    cfg = dataclasses.replace(get_preset(preset), eval_every=3)
    if impl is not None:
        cfg = dataclasses.replace(cfg, spmm_impl=impl)
    if stream is not None:
        monkeypatch.setattr(build, "make_edge_adapter",
                            functools.partial(adapters.make_edge_adapter, l2_stream_chunks=stream))
    data = _konect(tmp_path / "chess")
    n_epochs = 8  # evaluations at 0, 3, 6; plain chunks of 2, 2, 1
    with recording():
        exp = build.build_experiment(cfg, data_dir=data, device="cpu")
        tcfg = build.train_config(cfg, n_epochs=n_epochs)
        rows = build.run_trial(exp, tcfg, 0.5, torch.Generator().manual_seed(0))
    assert rows.shape == (n_epochs, 12)
    recs = records()
    named = {}
    for r in recs:
        named.setdefault(r["name"], []).append(r)
    assert len(named["setup.data"]) == len(named["setup.adapter"]) == 1
    for key in ("data", "adapter"):
        r = named[f"setup.{key}"][0]
        assert exp.seconds[key] == (r["end_ns"] - r["start_ns"]) / 1e9
    assert named["data.load"][0]["attrs"] == {"cached": False}
    assert {"data.load", "data.coo", "data.features"} | adapter_spans <= set(named)
    # Every COO build is a data.coo span, those inside data.load too.
    assert sum(r["attrs"]["nnz"] for r in named["data.coo"]) > 0
    by_id = {r["id"]: r for r in recs}

    def within(r, name):
        while r["parent"] is not None:
            r = by_id[r["parent"]]
            if r["name"] == name:
                return True
        return False

    assert all(within(r, "setup.data") for n in ("data.load", "data.features") for r in named[n])
    assert all(within(r, "setup.adapter") for n in adapter_spans for r in named[n])
    if "adapter.layer2" in adapter_spans:
        assert {r["attrs"]["operator"] for r in named["adapter.layer2"]} == {operator}
        assert all(("l2s_op" in b) == (stream is not None) for b in exp.adapter.bundles.values())
    (trial,) = named["loop.trial"]
    assert trial["attrs"] == {"trial": 0}
    assert [r["attrs"]["epoch"] for r in named["loop.eval"]] == [0, 3, 6]
    assert sum(r["attrs"]["n"] for r in named["loop.steps"]) == n_epochs
    assert [r["attrs"]["n"] for r in named["loop.fetch"]] == [1, 2, 1, 2, 1, 1]
    assert len(named["loop.rows"]) == 3 and len(named["loop.prepare"]) == 1
    assert len(named["loop.eval.forward"]) == len(named["loop.eval.score"]) == 6
    assert {r["attrs"]["window"] for r in named["loop.eval.forward"]} == {"val", "test"}
    for n in ("loop.prepare", "loop.eval", "loop.steps", "loop.fetch", "loop.rows"):
        assert all(r["attrs"]["trial"] == 0 and within(r, "loop.trial") for r in named[n])
    assert all(within(r, "loop.eval") for r in named["loop.eval.forward"])
    assert "loop.capture" not in named  # eager steps on the CPU: nothing captured
    # Off, the same run records nothing and returns the same rows.
    recording(False)
    again = build.run_trial(exp, tcfg, 0.5, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again, rows)
    assert len(records()) == len(recs)


@pytest.mark.parametrize("preset,changes,evals", [
    # Link prediction: evaluations at 0, 2 and 4 of 5 epochs.
    ("sbm_tmgcn_lp", dict(sbm_n_nodes=40, sbm_n_slices=10, beta1=2, beta2=2, eval_every=2,
                          alpha_vec=(0.9,)), 3),
    # Regression: chunks of 2, 2 and 1, val and test scored once at the end.
    ("seir_wdgcn_reg_tuned", dict(seir_n_nodes=60, seir_n_slices=20, eval_every=2), 1),
])
def test_link_prediction_and_regression_runs_open_the_loop_spans(preset, changes, evals):
    cfg = dataclasses.replace(get_preset(preset), n_trials=2, **changes)
    with recording():
        build.run_experiment(cfg, n_epochs=5, verbose=False, device="cpu")
    recs = records()
    trials = [r for r in recs if r["name"] == profiling.TRIAL]
    assert [r["attrs"]["trial"] for r in trials] == [0, 1]
    for t in (0, 1):
        mine = [r for r in recs if r["attrs"].get("trial") == t]
        assert sum(r["attrs"]["n"] for r in mine if r["name"] == "loop.steps") == 5
        assert sum(r["name"] == "loop.eval" for r in mine) == evals
        assert sum(r["name"] == "loop.eval.forward" for r in mine) == 2 * evals
        assert all(r["start_ns"] >= trials[t]["start_ns"] and r["end_ns"] <= trials[t]["end_ns"]
                   for r in mine)


def test_phase_events_need_a_card():
    A = SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        loop.train_chunks(A, None, None, loop.TrainConfig(), phase_events=True)


def test_step_phases_take_the_median_past_the_capture(monkeypatch):
    """``profile_slice.step_phases``: one epoch (the warm-up step and the
    capture) left out, then each epoch's phases read after it is waited
    for, and the median of each phase."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []

    def run(n):
        calls.append(n)
        return torch.zeros(1)

    forward = iter([1.0, 3.0, 2.0])
    # Read after the 2nd, 3rd and 4th epoch: 4, 6 and 8 ms.
    run.phase_ms = lambda: {"forward": next(forward), "backward": 2.0 * len(calls),
                            "update": 0.5}
    got = profile_slice.step_phases(run, n=3)
    assert calls == [1, 1, 1, 1]
    assert got == {"forward": 2.0, "backward": 6.0, "update": 0.5}


def _event(name, start, end, cuda=False, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end), is_user_annotation=annotation,
        device_type=torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU)


@pytest.mark.parametrize("events,share", [
    # Overlapping kernels count once: 10-40 and 50-60 of the range 0-100.
    ([_event("k1", 10, 30, True), _event("k2", 20, 40, True), _event("k1", 50, 60, True)], 0.4),
    # A kernel sticking out of the range counts inside it; a user range's
    # device copy (spanning kernels) and host events do not count.
    ([_event("k3", 90, 130, True), _event("ann", 0, 100, True, annotation=True),
      _event("aten::mm", 0, 50)], 0.1),
    # Kernels back to back over the whole range: 1, never more.
    ([_event("k", 0, 60, True), _event("k", 40, 100, True), _event("k", 10, 20, True)], 1.0),
])
def test_busy_share_is_the_union_of_device_intervals(events, share):
    got = profile_slice.busy_share([_event(profile_slice.RUN_RANGE, 0, 100), *events])
    assert got == pytest.approx(share)
