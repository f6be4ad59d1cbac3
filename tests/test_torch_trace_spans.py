"""The port's spans and counters (``ofot_tpu_torch/utils/trace.py``) on the
CPU, where ``loop="device"`` runs the device loop's eager form: off by
default, the tree each solve entry records, the device loop's launch and
flag-read spans against its replay counter, the ``dct.builds`` and
``sinkhorn.*`` counters, the bounded ring, and the clock anchors in a
profiler's trace."""

import json
from collections import Counter
from typing import NamedTuple

import numpy as np
import pytest
import torch

from ofot_tpu_torch.parallel import sweep
from ofot_tpu_torch.solvers import device_loop, foto, gn, sinkhorn, wfr
from ofot_tpu_torch.utils import trace

import fixtures

NT = 4
FOTO_KW = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.01, max_it=30)


@pytest.fixture(autouse=True)
def fresh_ring():
    """Each test starts with spans off and an empty ring, and leaves them
    so; one intra-op thread at these small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable(False)
    trace.clear()
    yield
    trace.enable(False)
    trace.clear()
    torch.set_num_threads(n)


def _pair(**kw):
    f1, f2 = fixtures.smooth_blob_pair(18, 20, dtype=np.float64, **kw)
    return torch.as_tensor(f1), torch.as_tensor(f2)


def _foto(ops=None, loop="device"):
    a, b = _pair()
    return foto.solve(a, b, NT, ops=ops or foto.stepA_ops("dct"), loop=loop,
                      **FOTO_KW)


def _wfr(loop="device"):
    a, b = _pair()
    return wfr.solve(a, b, NT, ops=foto.stepA_ops("dct"), loop=loop,
                     delta=2.5, admm_alpha=1.7, **FOTO_KW)


def _gn(loop="device"):
    a, b = _pair()
    return gn.solve_fields(a, b, loop=loop)


def _sinkhorn(loop="device"):
    a, b = _pair()
    return sinkhorn.solve_fields(a, b, 4.0, max_iter=300, tol=1e-4,
                                 loop=loop)


def _lockstep():
    pairs = [_pair(shift=s) for s in [(2.0, 1.0), (-1.0, 2.0)]]
    return sweep.solve_batch_full(
        "foto", torch.stack([a for a, _ in pairs]),
        torch.stack([b for _, b in pairs]),
        foto_params=dict(Nt=NT, stepA_solver="dct", **FOTO_KW),
        batch_mode="vmap", device="cpu")


def _builds(rec):
    """The ``dct.builds`` events of a record."""
    return [e for e in rec.events if e.name == "dct.builds"]


def _names(rec):
    return Counter(s.name for s in rec.spans)


def _one(rec, name):
    found = [s for s in rec.spans if s.name == name]
    assert len(found) == 1, (name, _names(rec))
    return found[0]


@pytest.mark.parametrize("solve", [_foto, _gn, _lockstep, _wfr],
                         ids=["foto", "gn", "lockstep", "wfr"])
def test_spans_off_by_default_record_nothing(solve):
    builds = trace.counts().get("dct.builds", 0)
    solve()
    rec = trace.spans()
    assert rec.spans == [] and rec.events == [] and rec.dropped == 0
    # the counter itself counts with spans off
    assert trace.counts()["dct.builds"] > builds


def test_annotate_off_is_one_shared_noop():
    assert trace.annotate("a") is trace.annotate("b")
    with trace.annotate("a"):
        pass
    assert trace.spans().spans == []


def test_foto_solve_is_a_root_over_its_loop_and_extraction():
    trace.enable(True)
    _foto()
    rec = trace.spans()
    root = _one(rec, "foto.solve")
    loop, extract = _one(rec, "alg2.loop"), _one(rec, "foto.extract")
    assert root.parent == -1 and root.request == root.index
    for child in (loop, extract):
        assert child.parent == root.index
        assert child.request == root.request
        assert root.start_ns <= child.start_ns <= child.end_ns \
            <= root.end_ns
    assert loop.end_ns <= extract.start_ns
    # every span of the solve shares the root's request id
    assert {s.request for s in rec.spans} == {root.index}


def test_wfr_solve_is_a_root_over_its_loop_and_extraction():
    trace.enable(True)
    _wfr()
    rec = trace.spans()
    root = _one(rec, "wfr.solve")
    loop, extract = _one(rec, "alg2.loop"), _one(rec, "wfr.extract")
    assert root.parent == -1 and root.request == root.index
    for child in (loop, extract):
        assert child.parent == root.index
        assert root.start_ns <= child.start_ns <= child.end_ns \
            <= root.end_ns
    assert loop.end_ns <= extract.start_ns
    assert {s.request for s in rec.spans} == {root.index}
    assert "foto.solve" not in _names(rec)


def _sinkhorn_counts():
    return {k: trace.counts().get(k, 0) for k in (
        "sinkhorn.iterations", "sinkhorn.exact_iterations",
        "sinkhorn.escalations")}


@pytest.mark.parametrize("loop", ["device", "host"])
def test_sinkhorn_solve_is_a_root_over_its_loops_verify_and_extraction(
        loop):
    """One ``sinkhorn.loop`` a stage (the ladder's three rungs, 100, 25
    and 6.25 at 18x20, and the final stage, a->b and a->a), a
    ``sinkhorn.verify`` a final matmul stage, one ``sinkhorn.extract``
    after them, all children of the root; the iterations counted as events
    under it, one a stage."""
    before = _sinkhorn_counts()
    _sinkhorn(loop)
    mid = _sinkhorn_counts()
    assert trace.spans().spans == []
    assert mid["sinkhorn.iterations"] > before["sinkhorn.iterations"]
    trace.enable(True)
    _sinkhorn(loop)
    after = _sinkhorn_counts()
    rec = trace.spans()
    root = _one(rec, "sinkhorn.solve")
    extract = _one(rec, "sinkhorn.extract")
    loops = [s for s in rec.spans if s.name == "sinkhorn.loop"]
    verify = [s for s in rec.spans if s.name == "sinkhorn.verify"]
    assert root.parent == -1 and len(loops) == 8 and len(verify) == 2
    for child in (*loops, *verify, extract):
        assert child.parent == root.index
        assert root.start_ns <= child.start_ns <= child.end_ns \
            <= root.end_ns
    assert max(s.end_ns for s in loops + verify) <= extract.start_ns
    events = [e for e in rec.events if e.name == "sinkhorn.iterations"]
    assert len(events) == 8 and {e.request for e in events} == {root.index}
    assert sum(e.n for e in events) == after["sinkhorn.iterations"] \
        - mid["sinkhorn.iterations"] == mid["sinkhorn.iterations"] \
        - before["sinkhorn.iterations"]
    for name in ("sinkhorn.exact_iterations", "sinkhorn.escalations"):
        assert after[name] == before[name]


@pytest.mark.parametrize("solve", [_foto, _gn], ids=["foto", "gn"])
def test_launch_spans_equal_replays_and_flag_reads_one_more(solve):
    trace.enable(True)
    replays = device_loop.stats.replays
    solve()
    replays = device_loop.stats.replays - replays
    names = _names(trace.spans())
    assert replays > 0
    assert names["device_loop.launch"] == replays
    assert names["device_loop.flag_read"] == replays + 1


@pytest.mark.parametrize("solve", [_foto, _gn, _wfr],
                         ids=["foto", "gn", "wfr"])
@pytest.mark.parametrize("loop", ["device", "host"])
def test_latch_slots_counted_once_a_replay(solve, loop):
    """``device_loop.latch_slots``: K a replay of a block whose fields go
    through the latch, one event a replay; the host loop counts none."""
    trace.enable(True)
    before = trace.counts().get("device_loop.latch_slots", 0)
    s0 = device_loop.stats.latch_slots, device_loop.stats.replays
    solve(loop=loop)
    events = [e for e in trace.spans().events
              if e.name == "device_loop.latch_slots"]
    slots = device_loop.stats.latch_slots - s0[0]
    assert trace.counts().get("device_loop.latch_slots", 0) - before \
        == slots == sum(e.n for e in events)
    assert len(events) == device_loop.stats.replays - s0[1]
    assert all(e.n == device_loop.BLOCK for e in events)
    assert (slots > 0) == (loop == "device")


class _Count(NamedTuple):
    x: torch.Tensor


def test_fori_loop_launch_spans_equal_replays():
    trace.enable(True)
    replays = device_loop.stats.replays
    out = device_loop.fori_loop(lambda s: _Count(s.x + 1),
                                _Count(torch.zeros(3)),
                                device_loop.BLOCK * 2 + 3)
    assert out.x.tolist() == [device_loop.BLOCK * 2 + 3] * 3
    names = _names(trace.spans())
    assert names["device_loop.launch"] == device_loop.stats.replays \
        - replays == 3
    assert names["device_loop.flag_read"] == 0


@pytest.mark.parametrize("loop", ["device", "host"])
def test_gn_records_setup_and_cg_loop_and_one_dct_build(loop):
    trace.enable(True)
    builds = trace.counts().get("dct.builds", 0)
    res = _gn(loop)
    rec = trace.spans()
    root = _one(rec, "gn.solve")
    setup, cg_loop = _one(rec, "gn.setup"), _one(rec, "cg.loop")
    assert setup.parent == cg_loop.parent == root.index
    assert setup.end_ns <= cg_loop.start_ns
    assert trace.counts()["dct.builds"] == builds + 1
    event, = _builds(rec)
    assert (event.n, event.request) == (1, root.index)
    assert setup.start_ns <= event.t_ns <= setup.end_ns
    assert res.cg.iterations > 0


def test_a_reused_ops_set_builds_its_dct_once():
    ops = foto.stepA_ops("dct")
    trace.enable(True)
    builds = trace.counts().get("dct.builds", 0)
    _foto(ops)
    assert trace.counts()["dct.builds"] == builds + 1
    _foto(ops)
    assert trace.counts()["dct.builds"] == builds + 1
    assert [e.n for e in _builds(trace.spans())] == [1]


def test_lockstep_batch_is_a_root_over_its_loop_and_extraction():
    trace.enable(True)
    _lockstep()
    rec = trace.spans()
    root = _one(rec, "sweep.batch")
    assert root.parent == -1
    for name in ("lockstep.loop", "lockstep.extract"):
        child = _one(rec, name)
        assert child.parent == root.index and child.request == root.index
    # a fresh ops set for the batch: one StepAPlan, one transform
    assert [e.name for e in rec.events] == ["dct.builds"]


def test_a_small_ring_drops_its_oldest_and_counts_them():
    trace.clear(capacity=4)
    trace.enable(True)
    for i in range(6):
        with trace.annotate(f"s{i}"):
            pass
    trace.count("c", 2)
    rec = trace.spans()
    assert [s.name for s in rec.spans] == ["s3", "s4", "s5"]
    assert [(e.name, e.n) for e in rec.events] == [("c", 2)]
    assert rec.dropped == 3
    trace.clear()
    assert trace.spans() == ([], [], 0)


def test_spans_nest_with_parent_indices_and_requests():
    trace.enable(True)
    with trace.annotate("a"):
        with trace.annotate("b"):
            with trace.annotate("c"):
                pass
    with trace.annotate("d"):
        pass
    by = {s.name: s for s in trace.spans().spans}
    assert by["a"].parent == -1 and by["d"].parent == -1
    assert by["b"].parent == by["a"].index
    assert by["c"].parent == by["b"].index
    assert by["a"].request == by["b"].request == by["c"].request \
        == by["a"].index
    assert by["d"].request == by["d"].index != by["a"].index


def test_root_and_phase_spans_are_trace_anchors_and_deeper_ones_not(
        tmp_path):
    d = tmp_path / "prof"
    with trace.profile(str(d)):
        with trace.annotate("root"):
            with trace.annotate("phase"):
                with trace.annotate("block"):
                    torch.ones(64).sum()
    assert trace._on is False           # profile() restores the flag
    events = json.loads(next(d.glob("*.pt.trace.json")).read_text())[
        "traceEvents"]
    marks = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"root", "phase"} <= marks
    assert "block" not in marks
    by = {s.name: s for s in trace.spans().spans}
    assert set(by) == {"root", "phase", "block"}
