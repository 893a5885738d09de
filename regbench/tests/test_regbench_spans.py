"""The metrics read from the program's own recorder (``regbench/spans.py``)
on small CPU runs of the single and batch mixes, traced: each reads a
number from the window's calls that no profiler recorded, and None where
the program has no recorder, where the records do not add up to the
window's pairs, or where every call was profiled."""
import dataclasses
import time

import pytest

from regbench import harness, spans
from regbench.tests.small import small_spec

SINGLE = ("extract_host_ms.single", "extract_enqueue_ms.single",
          "extract_rounds_per_pair.single", "prepare_host_ms.single",
          "core_host_ms.single")
BATCH = ("stage_in_ms.batch", "extract_frozen_pct.batch")
ONE = dict(warmup_calls=1, check_calls=1, trace_from_call=1, trace_calls=1)


@pytest.fixture(scope="module")
def traced():
    """A traced run of each mix (its second call profiled) and the
    program's records as that run left them."""
    from plade_tpu_torch.utils import timing
    out = {}
    for mix, changes in (("single", ONE),
                         ("batch8", dict(ONE, pairs_per_call=2,
                                         batch_pairs=2))):
        spec = small_spec(mix, rooms=2, **changes)
        _, _, run = harness.run_cell(spec, 2**31 + 7, 0.1, True,
                                     time.perf_counter(), device="cpu")
        out[mix] = run, timing.calls()
    return out


@pytest.fixture
def left(traced, monkeypatch):
    """``left(mix)``: that mix's run, with the program's records as its
    run left them (the readers read right after their run)."""
    from plade_tpu_torch.utils import timing

    def run_of(mix):
        run, records = traced[mix]
        monkeypatch.setattr(timing, "calls", lambda: records)
        return run
    return run_of


def _read(name, run):
    return harness.reader(name)(run)


@pytest.mark.parametrize("mix, per_call", [("single", 1), ("batch8", 2)])
def test_the_window_leaves_out_the_profiled_calls(left, mix, per_call):
    run = left(mix)
    calls = spans.window_calls(run)
    assert calls and not any(r["profiled"] for r in calls)
    # the traced stretch is one call of the window
    assert sum(r["pairs"] for r in calls) == run.pairs - per_call
    assert {r["entry"] for r in calls} == {
        harness.load_spec(f"resso60k.{mix}").traffic["entry"]}


def test_the_single_readers(left):
    run = left("single")
    host, enqueue, rounds, prepare, core = (_read(n, run) for n in SINGLE)
    calls = spans.window_calls(run)
    assert host == pytest.approx(sum(
        r["spans"]["extract"]["total_ns"] for r in calls) / 1e6 / len(calls))
    assert 0 < enqueue < host
    assert rounds == sum(r["counters"]["extract.rounds"]
                         for r in calls) / len(calls) >= 2
    assert prepare > 0 and core > 0


def test_the_batch_readers(left):
    run = left("batch8")
    stage_in, frozen = (_read(n, run) for n in BATCH)
    calls = spans.window_calls(run)
    assert stage_in == pytest.approx(sum(
        r["spans"][n]["total_ns"] for r in calls
        for n in ("entry.stage_in", "step.setup")) / 1e6 / (2 * len(calls)))
    assert stage_in > 0
    assert 0 <= frozen < 100
    assert frozen == pytest.approx(100 * sum(
        r["counters"]["extract.frozen"] for r in calls) / sum(
        r["counters"]["extract.cloud_rounds"] for r in calls))


@pytest.mark.parametrize("mix, names", [("single", SINGLE),
                                        ("batch8", BATCH)])
def test_none_without_a_recorder(left, monkeypatch, mix, names):
    run = left(mix)
    from plade_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "calls")
    for name in names:
        assert _read(name, run) is None, name


def test_none_where_the_records_do_not_add_up(left):
    batch = left("batch8")
    for run in (dataclasses.replace(batch, pairs=batch.pairs + 1),
                dataclasses.replace(batch, pairs=10**9),
                dataclasses.replace(batch, pairs=0)):
        for name in BATCH:
            assert _read(name, run) is None, name
    # the window's last call alone: the profiled one
    single = dataclasses.replace(left("single"), pairs=1)
    for name in SINGLE:
        assert _read(name, single) is None, name
