"""The port's spans and counters (``plade_tpu_torch/utils/timing.py``) on
the CPU.

* A span's self time is its duration less its children's; the process
  totals (``stage_report``) and the call's record agree.
* One record per outermost entry call, with its pairs (an entry inside
  another opens none); the records are bounded (``MAX_CALLS``).
* No ``record_function`` is entered while no profiler records; under a
  profiler the stages are ``plade.<stage>`` ranges and every other span a
  ``plade:<name>`` range, so that the benchmark's trace reduction
  (``regbench.trace.summarize``) sees only the stages.
* Extraction's counters: ``extract.rounds`` is the most rounds a cloud ran,
  ``extract.frozen`` the rounds of clouds already done (a 2-cloud lockstep
  extraction on the reference's replayed draws, one cloud ending early).
* Host reads by site: ``register_array_pairs`` copies 8 result fields a
  chunk (``entry.read_out``), each shard of a mesh 8 of its own (its
  ``shard.<k>.<device>`` span); two CPU shards credit one call record.

CPU tensors never count a kernel launch."""
import time

import jax
import pytest
import torch

from plade_tpu_torch.core import types as ptypes
from plade_tpu_torch.core.convert import config_from
from plade_tpu_torch.core.types import pad_cloud
from plade_tpu_torch.dist import mesh
from plade_tpu_torch.extract import ransac
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.pipeline import register_clouds
from plade_tpu_torch.utils import timing
from regbench import trace
from test_extract import TEST_CFG
from test_torch_extract import _replayed_draws, _scene
from torch_multihost_worker import CFG, make_pairs
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

#: the stages the registration of a pair runs at ``CFG`` (no final ICP)
STAGES = sorted(timing.STAGES - {"icp"})


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


@pytest.fixture(scope="module")
def pairs():
    return make_pairs(2)


def _last_call(run):
    """The records ``run()`` added, and the change of ``HOST_SYNCS``."""
    before = timing.calls()[-1]["id"] if timing.calls() else 0
    syncs = ptypes.HOST_SYNCS["count"]
    run()
    return ([r for r in timing.calls() if r["id"] > before],
            ptypes.HOST_SYNCS["count"] - syncs)


def test_nested_spans_split_self_time():
    timing.stage_report(reset=True)
    (rec,), _ = _last_call(_nested)
    rep = timing.stage_report(reset=True)
    outer, inner, root = (rec["spans"][n] for n in
                          ("unit.outer", "unit.inner", "call"))
    assert rec["entry"] == "unit" and rec["pairs"] == 3
    assert inner["count"] == 2 and outer["count"] == root["count"] == 1
    assert inner["self_ns"] == inner["total_ns"] >= 20e6
    assert outer["total_ns"] - outer["self_ns"] == inner["total_ns"]
    assert outer["self_ns"] >= 10e6
    assert root["total_ns"] - root["self_ns"] == outer["total_ns"]
    for name, span in (("unit.outer", outer), ("unit.inner", inner),
                       ("call", root)):
        assert rep[name]["count"] == span["count"]
        assert rep[name]["total"] == pytest.approx(span["total_ns"] / 1e9)
        assert rep[name]["self"] == pytest.approx(span["self_ns"] / 1e9)
    assert rep["unit.inner"]["mean"] == pytest.approx(
        rep["unit.inner"]["total"] / 2)
    assert rep["unit.inner"]["last"] >= 0.01


def _nested():
    with timing.call("unit", 3):
        with timing.stage("unit.outer"):
            time.sleep(0.01)
            for _ in range(2):
                with timing.stage("unit.inner"):
                    time.sleep(0.01)
        # an entry inside an open call opens no call of its own
        with timing.call("unit.nested", 5):
            timing.count("unit.counter", 2)
        timing.count("unit.counter")


def test_an_entry_inside_a_call_counts_into_it():
    (rec,), _ = _last_call(_nested)
    assert rec["counters"] == {"unit.counter": 3}
    assert not rec["profiled"]


def test_spans_outside_a_call_reach_only_the_totals():
    timing.stage_report(reset=True)
    with timing.stage("unit.alone"):
        timing.count("unit.lost")
        timing.host_read()
    assert timing.stage_report(reset=True)["unit.alone"]["count"] == 1


def test_the_records_are_bounded():
    for k in range(timing.MAX_CALLS + 5):
        with timing.call("unit", 1):
            pass
    recs = timing.calls()
    assert len(recs) == timing.MAX_CALLS
    ids = [r["id"] for r in recs]
    assert ids == list(range(ids[0], ids[0] + timing.MAX_CALLS))


def test_a_call_that_raises_is_recorded():
    with pytest.raises(ValueError):
        with timing.call("unit.raises", 4):
            raise ValueError
    assert timing.calls()[-1]["entry"] == "unit.raises"
    assert timing.calls()[-1]["pairs"] == 4


def test_no_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with timing.call("unit", 1):
        with timing.stage("extract"), timing.stage("extract.round"):
            pass
    assert entered == [] and not timing.profiling()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert timing.profiling()
        with timing.call("unit", 1):
            with timing.stage("extract"), timing.stage("extract.round"):
                pass
    assert entered == ["plade:call", "plade.extract", "plade:extract.round"]
    assert timing.calls()[-1]["profiled"]
    names = {e.name for e in prof.events()}
    assert {"plade:call", "plade.extract", "plade:extract.round"} <= names


def test_profiled_register_clouds_shows_only_the_stages(pairs):
    tp, tn, sp, sn = pairs[1]
    with trace.Stretch() as stretch:
        register_clouds(tp, tn, sp, sn, CFG, seed=0, device="cpu")
    s = trace.summarize(stretch.events)
    want = {f"plade.{n}" for n in STAGES}
    assert set(s.wall_ms) == want
    assert set(s.device_ms) <= want
    names = {e["name"] for e in stretch.events
             if e["name"].startswith("plade")}
    assert {n for n in names if n.startswith("plade.")} == want
    assert {"plade:call", "plade:entry.stage_in", "plade:extract.round",
            "plade:extract.draws", "plade:extract.done_read",
            "plade:entry.read_out"} == names - want
    assert timing.calls()[-1]["profiled"]


def test_register_clouds_record(pairs):
    tp, tn, sp, sn = pairs[0]
    (rec,), syncs = _last_call(lambda: register_clouds(
        tp, tn, sp, sn, CFG, seed=0, device="cpu"))
    assert rec["entry"] == "register_clouds" and rec["pairs"] == 1
    spans, counters = rec["spans"], rec["counters"]
    assert set(STAGES) <= set(spans)
    assert spans["extract"]["count"] == 2            # one a cloud
    assert spans["extract.round"]["count"] == counters["extract.rounds"]
    assert spans["extract.done_read"]["host_reads"] \
        == counters["extract.rounds"]
    # two plane counts, seven result scalars, the transform
    assert spans["entry.read_out"]["host_reads"] == 10
    assert counters["host_reads"] == syncs \
        == sum(s["host_reads"] for s in spans.values())
    assert counters["extract.frozen"] == 0           # one cloud a call
    assert counters["extract.cloud_rounds"] == counters["extract.rounds"]


def test_register_array_pairs_counts_its_result_copies(pairs):
    (rec,), syncs = _last_call(lambda: mesh.register_array_pairs(
        pairs, CFG, seed=0, device="cpu", batch_pairs=2))
    assert rec["entry"] == "register_array_pairs" and rec["pairs"] == 2
    spans, counters = rec["spans"], rec["counters"]
    # the 8 fields of one chunk's results
    assert spans["entry.read_out"]["host_reads"] == 8
    assert spans["entry.stage_in"]["count"] == 2     # the caps, one chunk
    assert spans["step.setup"]["count"] == 1
    assert counters["host_reads"] == syncs \
        == sum(s["host_reads"] for s in spans.values())
    rounds = counters["extract.rounds"]
    assert counters["extract.cloud_rounds"] == 4 * rounds
    assert spans["extract.done_read"]["host_reads"] == rounds


def test_two_cpu_shards_credit_one_call(pairs):
    timing.stage_report(reset=True)
    (rec,), syncs = _last_call(lambda: mesh.register_array_pairs(
        pairs, CFG, seed=0, mesh=mesh.make_mesh(devices=["cpu"] * 2),
        batch_pairs=1))
    rep = timing.stage_report(reset=True)
    spans, counters = rec["spans"], rec["counters"]
    for k in (0, 1):
        name = f"shard.{k}.cpu"
        assert spans[name]["count"] == 1
        assert spans[name]["host_reads"] == 8         # its result copies
        assert counters[f"shard.{k}.pairs"] == 1
        assert 0 < rep[name]["self"] < rep[name]["total"]
    # both shards' spans: two device steps, each extracting 2 clouds
    assert spans["step.setup"]["count"] == 2
    assert counters["extract.cloud_rounds"] == 2 * counters["extract.rounds"]
    # the mesh's results are on the host already: nothing read out
    assert spans["entry.read_out"]["host_reads"] == 0
    assert counters["host_reads"] == syncs


def test_frozen_clouds_of_a_lockstep_extraction(rng):
    """Two clouds in lockstep on the reference's replayed draws: one ends
    rounds before the other, and each of its rounds after that is a frozen
    cloud-round."""
    clouds = [_scene(rng, name)[:2] for name in ("single_plane", "room")]
    pad = 1 << (max(p.shape[0] for p, _ in clouds) - 1).bit_length()
    tcfg = config_from(TEST_CFG)
    batch = mesh.stack_clouds([pad_cloud(p, n, pad, "cpu")
                               for p, n in clouds])
    keys = jax.random.split(jax.random.PRNGKey(5))
    fn = ransac.build_extract_fn(tcfg, pad, max_extract=16)
    with timing.call("unit.extract", 1):
        _, stats = fn(batch.points, batch.normals, batch.count, 300,
                      draws=[_replayed_draws(k, pad, tcfg) for k in keys])
    counters = timing.calls()[-1]["counters"]
    rounds = stats.rounds.tolist()
    assert rounds[0] != rounds[1], rounds
    assert counters["extract.rounds"] == max(rounds)
    assert counters["extract.cloud_rounds"] == 2 * max(rounds)
    assert counters["extract.frozen"] == abs(rounds[0] - rounds[1])

