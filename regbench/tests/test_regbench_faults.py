"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run of a small cell on the CPU (the harness's
look for a card skipped: ``device="cpu"``) with one fault planted in the
program, and sees ``correct`` false by the check that should catch it:

* an answer altered where it is produced (a pose moved by 1.0; a K2
  distance; the spacing's distances);
* half of a batch left out, the answers of the rest standing in for it;
* the exchange between shards left out (one shard's results dropped);
* and, without a fault, the same run is correct.
"""
import functools
import time

import pytest
import torch

from regbench import capture
from regbench.harness import run_cell
from regbench.tests.small import small_spec

BATCH = dict(pairs_per_call=2, batch_pairs=2, warmup_calls=1,
             check_calls=1)


@pytest.fixture(scope="module")
def program():
    capture.installed()
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.dist import mesh
    from plade_tpu_torch.kernels import nn
    from plade_tpu_torch.knn import bruteforce
    return pipeline, mesh, nn, bruteforce


def _result(mix="batch8", devices=None, **changes):
    spec = small_spec(mix, rooms=2, chips=len(devices or [0]),
                      **{**BATCH, **changes})
    result, lines, _ = run_cell(spec, 11, 0.1, False, time.perf_counter(),
                                device="cpu", devices=devices)
    return result, {n for n, _, _, ok in lines if not ok}


def _run(mix="batch8", devices=None, **changes):
    result, failed = _result(mix, devices, **changes)
    return result["correct"], failed


def _moved(res):
    shift = torch.zeros_like(res.transform)
    shift[..., 0, 3] = 1.0
    return res._replace(transform=res.transform + shift)


def test_sound_runs_are_correct(program):
    assert _run() == (True, set())
    assert _run("single", warmup_calls=1, check_calls=1) == (True, set())


def test_failed_counts_pairs_without_a_finite_answer(program):
    from regbench import check
    result, _ = _result()
    assert result["attempted"] >= 2 and result["failed"] == 0
    transform = torch.eye(4).numpy()
    assert check.failed(None)
    assert not check.failed((transform, False))
    transform[0, 3] = float("nan")
    assert check.failed((transform, True))


def test_a_pose_altered_where_it_is_produced(program, monkeypatch):
    _, mesh, _, _ = program
    real = mesh.register_pair_device

    def step_of(*a, **kw):
        step = real(*a, **kw)
        return lambda *x, **y: _moved(step(*x, **y))
    monkeypatch.setattr(mesh, "register_pair_device", step_of)
    result, failed = _result()
    assert not result["correct"] and "pose_miss_share" in failed
    assert result["failed"] == 0        # a miss is an answer


def test_a_pose_altered_on_the_single_path(program, monkeypatch):
    pipeline = program[0]
    real = pipeline.register_pair
    monkeypatch.setattr(pipeline, "register_pair",
                        lambda *a, **kw: _moved(real(*a, **kw)))
    correct, failed = _run("single", warmup_calls=1, check_calls=1)
    assert not correct and "pose_miss_share" in failed


def test_half_of_the_batch_left_out(program, monkeypatch):
    _, mesh, _, _ = program
    real = mesh.register_batch

    def half(tgt, src, seeds, *a, **kw):
        h = max(1, len(seeds) // 2)
        res = real(type(tgt)(*(x[:h] for x in tgt)),
                   type(src)(*(x[:h] for x in src)), seeds[:h], *a, **kw)
        return type(res)(*(torch.cat([x] * len(seeds))[:len(seeds)]
                           for x in res))
    monkeypatch.setattr(mesh, "register_batch", half)
    correct, failed = _run(pairs_per_call=2)
    assert not correct and "pose_miss_share" in failed


def test_the_exchange_between_shards_left_out(program, monkeypatch):
    _, mesh, _, _ = program
    real = mesh._register_shards

    def first_shard_only(tgt, src, seeds, cfg, groups, draws):
        res = real(tgt, src, seeds, cfg, groups, draws)
        keep = mesh._bounds(len(seeds), len(groups))[1]
        return type(res)(*(x[:keep] for x in res))
    monkeypatch.setattr(mesh, "_register_shards", first_shard_only)
    # no warm-up: a warm-up call that raises ends the run before its
    # window, with no result at all
    result, failed = _result("batch8.mesh4", devices=["cpu", "cpu"],
                             pairs_per_call=4, batch_pairs=2,
                             warmup_calls=0)
    assert not result["correct"] and "unanswered" in failed
    assert result["failed"] > 0


def test_a_k2_answer_altered(program, monkeypatch):
    nn = program[2]
    real = nn.nearest_neighbor_plain

    def off(q, r):
        d, i = real(q, r)
        return d * (1 + 1e-4), i
    monkeypatch.setattr(nn, "nearest_neighbor_plain", off)
    correct, failed = _run()
    assert not correct and "k2_gap" in failed


def test_a_k1_answer_altered(program, monkeypatch):
    nn = program[2]
    real = nn.oriented_min_dist_sq_plain
    monkeypatch.setattr(nn, "oriented_min_dist_sq_plain",
                        lambda *a: real(*a) * (1 + 1e-4))
    correct, failed = _run()
    assert not correct and "k1_gap" in failed


def test_the_spacing_altered(program, monkeypatch):
    bruteforce = program[3]
    real = bruteforce._block_dist_sq
    monkeypatch.setattr(bruteforce, "_block_dist_sq",
                        lambda q, r: real(q, r) * 1.01)
    correct, failed = _run()
    assert not correct and "spacing_gap" in failed


def test_the_control_comes_out_not_correct(program):
    """The control (the reference in TF32 put in the program's place for
    the spacing and the K1/K2 answers) fails its numbers on the CPU, where
    TF32 is emulated by rounding the products' operands."""
    from regbench import check
    spec = small_spec("batch8", rooms=2, **BATCH)
    result, lines, _ = run_cell(
        spec, 11, 0.1, False, time.perf_counter(), device="cpu",
        check_fn=functools.partial(check.check, control=True))
    failed = {n for n, _, _, ok in lines if not ok}
    assert not result["correct"]
    assert {"spacing_gap", "k2_gap", "k1_gap"} <= failed
