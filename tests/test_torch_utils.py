"""The port's stage timers and profiler hook (``utils/timing.py``): the cases
of ``tests/test_utils.py`` beside the reference package's, a stage that
waits on CPU tensors, and a trace written by ``profiler_trace``."""
import json
import time

import torch

from plade_tpu.utils import timing as jtiming
from plade_tpu_torch.utils import timing


def test_stopwatch_formatting():
    w = timing.StopWatch()
    time.sleep(0.01)
    assert w.elapsed_seconds() >= 0.01
    assert any(u in w.time_string() for u in ("ms", "s"))


def test_stopwatch_strings_match_the_reference(monkeypatch):
    for s in (2e-4, 0.0123, 4.5, 75.0, 3725.0):
        strings = []
        for mod in (timing, jtiming):
            w = mod.StopWatch()
            monkeypatch.setattr(w, "elapsed_seconds", lambda s=s: s)
            strings.append(w.time_string())
        assert strings[0] == strings[1], (s, strings)


def test_stage_records(capfd):
    timing.stage_report(reset=True)
    with timing.stage("unit/st", verbose=True):
        time.sleep(0.005)
    rep = timing.stage_report(reset=True)
    assert "unit/st" in rep and rep["unit/st"]["count"] == 1
    assert rep["unit/st"]["last"] >= 0.005
    assert "[plade] unit/st" in capfd.readouterr().out
    assert timing.stage_report() == {}


def test_stage_syncs_on_cpu_tensors():
    """``sync`` (or ``out["sync"]``) with CPU tensors waits on no card."""
    x = torch.ones(3)
    with timing.stage("unit/cpu", sync={"a": [x, (x, 1)], "b": None}):
        pass
    with timing.stage("unit/cpu") as out:
        out["sync"] = x * 2
    rep = timing.stage_report(reset=True)
    assert rep["unit/cpu"]["count"] == 2
    assert timing._cuda_devices([x, {"k": (x,)}, None, 3]) == set()


def test_print_progress(capfd):
    timing.print_progress(0.5, width=10)
    timing.print_progress(1.5, width=10)
    out = capfd.readouterr().out
    assert "[#####-----]  50.0%" in out
    assert out.endswith("[##########] 100.0%\n")


def test_profiler_trace_writes_its_trace(tmp_path):
    with timing.profiler_trace(str(tmp_path / "trace")):
        with torch.profiler.record_function("plade.unit"):
            torch.ones(64).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "plade.unit" for e in trace["traceEvents"])
