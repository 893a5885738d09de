"""The reduction of a profiler trace, on a hand-made one: two streams of
one card overlapping, kernels attributed by the range of the thread that
launched them, idle gaps by the host's range."""
import pytest

from regbench import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": args.pop("pid", 0), "args": args}


EVENTS = [
    _x("user_annotation", "regbench.stretch", 0, 100),
    _x("user_annotation", "plade.extract", 0, 40),
    _x("user_annotation", "plade.rescore", 50, 40),
    _x("user_annotation", "regbench.k2", 55, 10),
    # launches (host), correlation ids 1-4; 5 from another thread
    _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 56, 1, correlation=3),
    _x("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 56, 1, tid=2, correlation=5),
    # device: stream 7 and stream 8 overlap on [20, 30]
    _x("kernel", "ransac_a", 10, 20, device=0, stream=7, correlation=1),
    _x("kernel", "ransac_b", 20, 20, device=0, stream=8, correlation=2),
    _x("kernel", "nn_kernel", 60, 10, device=0, stream=7, correlation=3),
    _x("gpu_memset", "Memset", 75, 5, device=0, stream=7, correlation=4),
    _x("kernel", "other", 60, 10, device=1, stream=7, correlation=5),
]


def test_summary():
    s = trace.summarize(EVENTS, live=[("k2", [4], [5])])
    assert s.window_s == pytest.approx(100e-6)
    # device 0: [10, 40] and [60, 70] and [75, 80]
    assert s.busy_s[0] == pytest.approx(45e-6)
    assert s.busy_s[1] == pytest.approx(10e-6)
    assert s.device_ms["plade.extract"] == pytest.approx(40e-3)
    assert s.device_ms["plade.rescore"] == pytest.approx(15e-3)
    assert s.device_ms["regbench.k2"] == pytest.approx(10e-3)
    # the other thread's launch lies in no range of its own thread
    assert sum(s.device_ms.values()) == pytest.approx(65e-3)
    assert s.wall_ms["plade.extract"] == pytest.approx(40e-3)
    assert s.kernels == 4
    assert s.kernel_least_s["k2"] == pytest.approx(
        max(8 * 20 / 67e12, (12 * 9 + 8 * 4) / 3.35e12))
    assert s.device_ops[0] == ["ransac_a", pytest.approx(20e-6)]
    idle = dict(s.idle_gaps)
    # a gap goes to the range, at its start, of the thread that launched
    # most of the device's work: device 0's thread 1 ([0, 10] and [40, 60]
    # extract, [70, 75] and [80, 100] rescore); device 1's thread 2 has no
    # plade range
    assert idle["plade.extract"] == pytest.approx((10 + 20) * 1e-6)
    assert idle["plade.rescore"] == pytest.approx((5 + 20) * 1e-6)
    assert idle["(host outside plade ranges)"] == pytest.approx(90e-6)


def test_a_trace_without_the_stretch_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize(EVENTS[1:])
