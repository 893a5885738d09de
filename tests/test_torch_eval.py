"""The port's evaluation suite (``plade_tpu_torch/tools/run_eval.py``)
beside the JAX package's ``tools/run_eval.py``, on the CPU.

(a) ``SCENES``, ``N_POINTS``, ``REPEATS`` and ``SIZE`` are the JAX
    script's; the port's tools and ``chip_smoke.py`` import neither JAX nor
    the JAX package.
(b) ``build_scene`` writes the JAX script's PLYs and ground truth byte for
    byte (a development scene and a holdout, at a small ``N_POINTS``).
(c) On a small scene of the suite's generator, the port's pairs on the
    JAX package's replayed draws match the JAX package's
    ``evaluate_scene(device_batch=True)``: transforms within 0.1 deg and
    1e-3, success flags and recall equal.
(d) ``main(["--device", "cpu", ...])`` on two small scenes writes the
    markdown table and the JSON file with every scene's row and every
    pair's result, and exits 1 when a scene's recall is below the
    reference column; the aggregation is the JAX script's formulas.
(e) Without a card and without ``--device cpu``, ``main`` raises before it
    builds a scene.
"""
import dataclasses
import filecmp
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from plade_tpu.core.config import PladeConfig as JPladeConfig
from plade_tpu.dist import mesh as jmesh
from plade_tpu.io import resso as jresso
from plade_tpu_torch.io import resso
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.pipeline import _pad_size
from plade_tpu_torch.tools import run_eval
from torch_eval_replay import (jax_keys, pose_error, port_on_draws,
                               scene_pairs)
from torch_multihost_worker import CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: scans of the small scenes: enough points for the small config's planes
SMALL_POINTS = 6000


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


@pytest.fixture(scope="module")
def jax_eval():
    """The JAX package's ``tools/run_eval.py``, loaded by path (its import
    points JAX's compile cache at the git-ignored ``.jax_cache/``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_eval", os.path.join(REPO, "tools", "run_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(name, n_scans=3):
    """A suite scene cut to ``n_scans`` scans."""
    sc, = [s for s in run_eval.SCENES if s["name"] == name]
    return dict(sc, n_scans=n_scans)


# ------------------------------------------------------------------ (a)

def test_scenes_are_the_jax_scripts(jax_eval):
    assert run_eval.SCENES == jax_eval.SCENES
    assert [s["holdout"] for s in run_eval.SCENES] == [False] * 5 + [True] * 3
    assert (run_eval.N_POINTS, run_eval.REPEATS, run_eval.SIZE) == \
        (jax_eval.N_POINTS, jax_eval.REPEATS, jax_eval.SIZE) == \
        (60000, 3, 4.0)
    assert run_eval.DEFAULT_BASE != "/tmp/plade_synth_resso"


#: an import of JAX or of the JAX package (``plade_tpu_torch`` is not one)
JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|plade_tpu)(\.|\s|$)",
                        re.M)


@pytest.mark.parametrize("path", [
    "chip_smoke.py", "plade_tpu_torch/tools/__init__.py",
    "plade_tpu_torch/tools/run_eval.py"])
def test_tools_import_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        assert not JAX_IMPORT.search(f.read())


def test_run_eval_imports_without_jax():
    code = ("import sys; import plade_tpu_torch.tools.run_eval; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'plade_tpu' or m.startswith('plade_tpu.') "
            "or m == 'tools' or m.startswith('tools.') "
            "for m in sys.modules), 'the JAX side imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("name", ["office_clean", "holdout_tower"])
def test_build_scene_writes_the_jax_scripts_files(jax_eval, name, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(run_eval, "N_POINTS", 3000)
    monkeypatch.setattr(jax_eval, "N_POINTS", 3000)
    sc, = [s for s in run_eval.SCENES if s["name"] == name]
    ours = run_eval.build_scene(sc, str(tmp_path / "torch"))
    theirs = jax_eval.build_scene(sc, str(tmp_path / "jax"))
    files = sorted(os.listdir(ours))
    assert files == sorted(os.listdir(theirs))
    assert len([f for f in files if f.endswith(".ply")]) == sc["n_scans"]
    assert "groundtruth.txt" in files
    match, mismatch, errors = filecmp.cmpfiles(ours, theirs, files,
                                               shallow=False)
    assert (mismatch, errors) == ([], [])
    # a directory with every scan is reused, not rewritten
    stamp = os.path.getmtime(os.path.join(ours, "scan_00.ply"))
    assert run_eval.build_scene(sc, str(tmp_path / "torch")) == ours
    assert os.path.getmtime(os.path.join(ours, "scan_00.ply")) == stamp


# ------------------------------------------------------------------ (c)

def test_pairs_on_replayed_draws_match_jax_evaluate_scene(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(run_eval, "N_POINTS", SMALL_POINTS)
    scene = resso.load_scene(run_eval.build_scene(_small("office_noisy"),
                                                  str(tmp_path)))
    jscene = jresso.load_scene(os.path.dirname(scene.scan_files[0]))
    # repeat 1 of the suite: seed 1000, the pairs in reverse order
    order = resso.consecutive_pairs(scene)[::-1]
    want = jresso.evaluate_scene(
        jscene, cfg=JPladeConfig(**dataclasses.asdict(CFG)),
        device_batch=True, seed=1000, pairs=order,
        mesh=jmesh.make_mesh(1, intra=1, devices=jax.devices("cpu")[:1]),
        verbose=False)
    cloud_pairs, n = scene_pairs(scene, order)
    res = port_on_draws(cloud_pairs, jax_keys(1000, len(order)), CFG,
                        _pad_size(n, maximum=CFG.max_points))
    got = resso.EvalSummary()
    for k, (pair, w) in enumerate(zip(order, want.results)):
        T = res.transform[k].numpy()
        rot, trans = pose_error(scene, pair, T)
        got.results.append(resso.PairResult(
            w.target, w.source, T, bool(res.success[k]), rot, trans))
        assert got.results[-1].success == w.success, pair
        assert resso.rotation_error_deg(T[:3, :3], w.transform[:3, :3]) \
            < 0.1, pair
        assert np.linalg.norm(T[:3, 3] - w.transform[:3, 3]) < 1e-3, pair
    assert got.recall == want.recall
    # the scene holds a pair that registers and one that does not
    assert sorted(r.success for r in got.results) == [False, True]


# ------------------------------------------------------------------ (d)

def _summary(errs):
    s = resso.EvalSummary()
    s.results = [resso.PairResult("a", "b", np.eye(4), True, r, t)
                 for r, t in errs]
    return s


def test_aggregation_is_the_jax_scripts():
    reps = [_summary([(1.0, 0.1), (30.0, 2.0), (2.0, 0.4)]),
            _summary([(1.0, 0.1), (3.0, 0.6), (2.0, 0.4)]),
            _summary([(9.0, 0.1), (3.0, 0.2), (2.0, 0.3)])]
    dts = [3.0, 1.5, 2.0]
    rec, recalls, rmse, rmses, spp = run_eval.scene_stats(reps, dts)
    # tools/run_eval.py:122-125
    assert recalls == [s.recall for s in reps] == [2 / 3, 2 / 3, 2 / 3]
    assert rec == float(np.mean(recalls))
    assert rmses == [s.rmse_trans for s in reps]
    assert rmse == float(np.sqrt(np.mean(np.square(rmses))))
    assert spp == min(dts) / 3
    # tools/run_eval.py:133-136
    rows = [(5, 0.8, 0.36), (4, 1.0, 0.02), (7, 0.714, 0.56)]
    total, recall, rmse_all = run_eval.overall(rows)
    assert total == 16
    assert recall == sum(n * r for n, r, _ in rows) / 16
    assert rmse_all == float(np.sqrt(sum(n * e ** 2 for n, _, e in rows)
                                     / 16))


def _run(name, recall, holdout=False):
    return run_eval.SceneRun(dict(_small(name), holdout=holdout), 2, recall,
                             [recall], 0.1, [0.1], 1.0, [2.0], [[]])


def test_report_against_the_reference(tmp_path):
    runs = [_run("office_noisy", 0.5), _run("holdout_sparse", 1.0, True)]
    ref = {"office_noisy": {"pairs": 5, "recall": 0.4, "rmse_trans": 5.3},
           "holdout_sparse": {"pairs": 4, "recall": 0.5, "rmse_trans": 1.6,
                              "recalls": [0.5, 0.5, 0.5]}}
    out = str(tmp_path / "eval")
    assert run_eval.write_report(runs, ref, out, "cpu", 1, 1.0)
    ref["office_noisy"]["recall"] = 0.6
    assert not run_eval.write_report(runs, ref, out, "cpu", 1, 1.0)
    # no reference column at all: the JAX script's exit 1
    assert not run_eval.write_report(runs, {}, out, "cpu", 1, 1.0)


def test_main_on_two_small_scenes(tmp_path, monkeypatch):
    from plade_tpu_torch.core import config
    monkeypatch.setattr(run_eval, "N_POINTS", SMALL_POINTS)
    monkeypatch.setattr(run_eval, "SCENES", [_small("office_noisy"),
                                             _small("holdout_sparse")])
    monkeypatch.setattr(config, "PladeConfig", lambda: CFG)
    ref = {"office_noisy": {"pairs": 2, "recall": 0.0, "rmse_trans": 1.0},
           "holdout_sparse": {"pairs": 2, "recall": 1.01, "rmse_trans": 1.0,
                              "recalls": [1.0, 1.02]}}
    ref_path = tmp_path / "REF_EVAL.json"
    ref_path.write_text(json.dumps(ref))
    monkeypatch.setattr(run_eval, "REF_EVAL", str(ref_path))
    out = tmp_path / "out" / "eval_torch"
    rc = run_eval.main(["--device", "cpu", "--repeats", "2", "--base",
                        str(tmp_path / "scenes"), "--out", str(out)])
    assert rc == 1                    # holdout_sparse is below 1.01
    md = (tmp_path / "out" / "eval_torch.md").read_text()
    rows = [ln for ln in md.splitlines() if ln.startswith("| ")][1:]
    assert [r.split(" | ")[0] for r in rows] == [
        "| office_noisy", "| holdout_sparse (holdout)"]
    assert "0.000 | 1.000 |" in rows[0] and "1.010 [1.00-1.02]" in rows[1]
    assert "**Overall: recall" in md and "over 4 pairs x 2 repeats" in md
    data = json.loads((tmp_path / "out" / "eval_torch.json").read_text())
    assert (data["n_points"], data["repeats"]) == (SMALL_POINTS, 2)
    runs = []
    for sc, want in zip(data["scenes"], ("office_noisy", "holdout_sparse")):
        assert (sc["name"], sc["pairs"]) == (want, 2)
        first, second = sc["results"]
        assert [p["pair"] for p in first] == [[0, 1], [1, 2]]
        assert [p["pair"] for p in second] == [[1, 2], [0, 1]]
        for rep, recall in zip(sc["results"], sc["recalls"]):
            assert recall == np.mean([p["rot_err_deg"] < 5.0
                                      and p["trans_err"] < 0.5 for p in rep])
            for p in rep:
                assert p["recalled"] == (p["rot_err_deg"] < 5.0
                                         and p["trans_err"] < 0.5)
                assert np.isfinite(p["transform"]).all()
                assert set(run_eval.COUNTERS) <= set(p)
        assert sc["recall"] == np.mean(sc["recalls"])
        assert sc["s_per_pair"] == min(sc["walls"]) / 2
        runs.append((sc["pairs"], sc["recall"], sc["rmse_trans"]))
    assert tuple(data["overall"].values()) == run_eval.overall(runs)
    assert data["ref_recall"] == pytest.approx((0.0 * 2 + 1.01 * 2) / 4)


# ------------------------------------------------------------------ (e)

def test_main_without_a_card_raises_before_any_scene(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_scene(*a, **k):
        raise AssertionError("a scene was built")
    monkeypatch.setattr(run_eval, "build_scene", no_scene)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_eval.main(["--base", str(tmp_path / "scenes"), "--out",
                       str(tmp_path / "eval")])
    assert not (tmp_path / "scenes").exists()
    assert not list(tmp_path.iterdir())
