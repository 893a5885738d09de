"""The port's command line (``python -m plade_tpu_torch.cli``) on the CPU
with ``--device cpu``: the cases of ``tests/test_cli.py`` (single pair,
batch with a missing file, usage, both resume cases, view as PLY and as
HTML) at ``SMALL_CFG`` sizes, and its agreement with ``plade_tpu.cli``:
the resume run key, the result file format and the pairs-file reader.
Without a card and without ``--device cpu`` the CLI raises.  CPU tensors
run the plain kernel versions: no launch is counted."""
import base64
import importlib
import json
import os

import numpy as np
import pytest
import torch

import plade_tpu.cli.viewer as jviewer
from plade_tpu.core.config import PladeConfig as JConfig
from plade_tpu_torch.cli.main import main
from plade_tpu_torch.cli.viewer import _parse_results
from plade_tpu_torch.core.config import PladeConfig as TConfig
from plade_tpu_torch.io.ply import read_ply, write_ply
from plade_tpu_torch.io.synthetic import (make_room, random_rigid,
                                          transform_cloud)
from plade_tpu_torch.kernels import nn
from test_pipeline import SMALL_CFG, rotation_error_deg
from test_torch_register import CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# the modules, not the ``main`` functions their packages export
jcli = importlib.import_module("plade_tpu.cli.main")
tcli = importlib.import_module("plade_tpu_torch.cli.main")


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_scene")
    rng = np.random.default_rng(0)
    pts, nrm, _ = make_room(rng, n_per_plane=1200, noise=0.002, extra_planes=3)
    R, t = random_rigid(rng, max_angle=1.5, max_trans=1.0)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    tgt = str(d / "target.ply")
    src = str(d / "source.ply")
    write_ply(tgt, pts, nrm)
    write_ply(src, spts, snrm)
    return d, tgt, src, R, t


def _patch_small_cfg(monkeypatch):
    import plade_tpu_torch.core.config as cfgmod
    monkeypatch.setattr(cfgmod, "PladeConfig", lambda **kw: CFG)


def _result(d, tgt, src):
    """The single-pair result file of the scene, made once."""
    res = str(d / "result.txt")
    if not os.path.exists(res):
        assert main([tgt, src, res, "--device", "cpu"]) == 0
    return res


def test_single_pair_mode(scene, monkeypatch):
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    out = _result(d, tgt, src)
    text = open(out).read()
    assert f"target: {tgt}" in text and f"source: {src}" in text
    assert "transformation:" in text
    rows = [l.split() for l in text.splitlines()[3:7]]
    T = np.asarray(rows, np.float64)
    assert np.allclose(T[3], [0, 0, 0, 1])
    assert rotation_error_deg(R, T[:3, :3]) < 3.0


@pytest.mark.parametrize("device_batch", [False, True],
                         ids=["sequential", "device_batch"])
def test_batch_mode_with_missing_file(scene, monkeypatch, capsys,
                                      device_batch):
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    pairs = str(d / "pairs.txt")
    with open(pairs, "w") as f:
        f.write(f"{tgt}\n{src}\n")
        f.write(f"{d}/nonexistent.ply\n")  # skipped with a warning
    out = str(d / f"batch_results_{device_batch}.txt")
    rc = main([pairs, out, "--device", "cpu"]
              + (["--device-batch"] if device_batch else []))
    assert rc == 0
    text = open(out).read()
    assert text.count("transformation:") == 1
    err = capsys.readouterr().err
    assert "doesn't exist" in err
    _, _, T = _parse_results(out)
    assert rotation_error_deg(R, T[:3, :3]) < 3.0


def test_usage_error():
    with pytest.raises(SystemExit):
        main(["only-one-path", "--device", "cpu"])


def _seed_state(state, run_key, tgt, src, T, ok):
    with open(state, "w") as f:
        f.write(json.dumps({"run_key": run_key}) + "\n")
        f.write(json.dumps({"target": tgt, "source": src,
                            "T": T.tolist(), "ok": ok}) + "\n")


@pytest.mark.parametrize("device_batch", [False, True],
                         ids=["sequential", "device_batch"])
def test_batch_resume_skips_completed(scene, monkeypatch, capsys,
                                      device_batch):
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    pairs = str(d / "pairs_resume.txt")
    with open(pairs, "w") as f:
        f.write(f"{tgt}\n{src}\n")
    out = str(d / "resume_results.txt")
    state = out + ".state.jsonl"
    # pre-seed the state file with a fake completed result: resume must
    # reuse it without re-running the pipeline.  The header must carry the
    # run key (config/seed/pairs fingerprint) or the state is discarded.
    from plade_tpu_torch.cli.main import _run_key
    from plade_tpu_torch.core.config import PladeConfig
    run_key = _run_key(PladeConfig(), 0, [(tgt, src)])
    fakeT = np.diag([1.0, 1.0, 1.0, 1.0])
    _seed_state(state, run_key, tgt, src, fakeT, True)
    rc = main(["--resume", pairs, out, "--device", "cpu"]
              + (["--device-batch"] if device_batch else []))
    assert rc == 0
    err = capsys.readouterr().err
    assert "resuming: 1 pairs" in err
    text = open(out).read()
    rows = [l.split() for l in text.splitlines()[3:7]]
    T = np.asarray(rows, np.float64)
    assert np.allclose(T, fakeT)  # the checkpointed matrix, not a re-run
    assert not os.path.exists(state)  # clean finish drops the checkpoint


def test_batch_resume_retries_failed_and_discards_stale(scene, monkeypatch,
                                                        capsys):
    """Pairs checkpointed with ok=False must be re-run, and a state file
    written under a different config/seed/pair list must be discarded."""
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    pairs = str(d / "pairs_retry.txt")
    with open(pairs, "w") as f:
        f.write(f"{tgt}\n{src}\n")
    out = str(d / "retry_results.txt")
    state = out + ".state.jsonl"
    from plade_tpu_torch.cli.main import _run_key
    from plade_tpu_torch.core.config import PladeConfig
    run_key = _run_key(PladeConfig(), 0, [(tgt, src)])
    # ok=False record: must NOT be treated as done
    _seed_state(state, run_key, tgt, src, np.eye(4), False)
    rc = main(["--resume", pairs, out, "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "resuming" not in err            # nothing counted as completed
    rows = [l.split() for l in open(out).read().splitlines()[3:7]]
    T = np.asarray(rows, np.float64)
    assert not np.allclose(T, np.eye(4))    # actually re-registered

    # stale run_key: whole state discarded, pair re-run
    _seed_state(state, "deadbeef", tgt, src, np.eye(4), True)
    rc = main(["--resume", pairs, out, "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "different config" in err
    rows = [l.split() for l in open(out).read().splitlines()[3:7]]
    T = np.asarray(rows, np.float64)
    assert not np.allclose(T, np.eye(4))


def test_view_export(scene, monkeypatch, tmp_path):
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    res = _result(d, tgt, src)
    prefix = str(tmp_path / "view")
    rc = main(["view", res, prefix, "--device", "cpu"])
    assert rc == 0
    tp, _ = read_ply(prefix + "_target.ply")
    sp2, _ = read_ply(prefix + "_source_registered.ply")
    # registered source should lie near the target (same scene)
    assert tp.shape[1] == 3 and sp2.shape[1] == 3
    assert np.linalg.norm(sp2.mean(0) - tp.mean(0)) < 0.5


def test_view_html_interactive(scene, monkeypatch, tmp_path):
    """`view RES OUT.html` emits the self-contained interactive WebGL
    viewer: embedded base64 point buffers decode to the pair's clouds with
    the source transformed by the recorded matrix.  With ``--profile`` the
    run's trace is written."""
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    res = _result(d, tgt, src)
    out = str(tmp_path / "view.html")
    trace_dir = tmp_path / "trace"
    rc = main(["view", res, out, "--device", "cpu", "--profile",
               str(trace_dir)])
    assert rc == 0
    html = open(out).read()
    assert "<canvas" in html and "webgl" in html
    assert "http" not in html.split("<script>")[1]  # no external fetches
    _, _, T = _parse_results(res)

    def decode(marker):
        b64 = html.split(f'{marker}="')[1].split('"')[0]
        return np.frombuffer(base64.b64decode(b64), np.float32).reshape(-1, 3)

    tp_emb = decode("TGT_P")
    sp_emb = decode("SRC_P")
    tp, _ = read_ply(tgt)
    sp, _ = read_ply(src)
    assert tp_emb.shape[0] == tp.shape[0]  # below cap: no subsample
    sp_expect = sp @ T[:3, :3].T + T[:3, 3]
    assert np.allclose(sp_emb, sp_expect, atol=1e-4)
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert trace["traceEvents"]


def test_no_card_raises_without_device_cpu(scene, monkeypatch):
    """Without a card and without --device cpu, main raises the error that
    names device="cpu" before any file is opened: nothing falls back to
    the CPU."""
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(d / "no_card.txt")
    for argv in ([tgt, src, out], [tgt, src, out, "--device", "cuda"],
                 ["view", str(d / "result.txt"), str(d / "no_card.html")]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(argv)
    assert not os.path.exists(out)
    assert not os.path.exists(d / "no_card.html")


def test_run_key_matches_reference():
    """The run key hashes the config's repr, which the port's PladeConfig
    shares with the reference's: a resume state file is interchangeable
    between the two CLIs."""
    pairs = [("a.ply", "b.ply"), ("c.ply", "d.ply")]
    for jcfg, tcfg in ((JConfig(), TConfig()),
                       (JConfig(enable_icp=True), TConfig(enable_icp=True)),
                       (SMALL_CFG, CFG)):
        assert repr(tcfg) == repr(jcfg)
        for seed in (0, 7):
            assert tcli._run_key(tcfg, seed, pairs) == \
                jcli._run_key(jcfg, seed, pairs)
    assert tcli._run_key(TConfig(), 0, pairs) != \
        tcli._run_key(TConfig(enable_icp=True), 0, pairs)


def test_result_file_and_pairs_reader_match_reference(scene, monkeypatch,
                                                      capsys, tmp_path):
    """A result file written by the port parses with the reference
    viewer's reader (single-pair and failure blocks), and both packages'
    pairs-file readers give the same pairs and warnings."""
    d, tgt, src, R, t = scene
    _patch_small_cfg(monkeypatch)
    res = _result(d, tgt, src)
    jt, js, jT = jviewer._parse_results(res)
    tt, ts, tT = _parse_results(res)
    assert (jt, js) == (tt, ts) == (tgt, src)
    np.testing.assert_array_equal(jT, tT)
    failed = tmp_path / "failed.txt"
    with open(failed, "w") as out:
        tcli._write_single(out, tgt, src, None, False)
        out.write("\n")
        tcli._write_single(out, src, tgt, tT, True)
    for index in (0, 1):
        a, b = jviewer._parse_results(str(failed), index), \
            _parse_results(str(failed), index)
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(_parse_results(str(failed))[2], np.eye(4))

    pairs = tmp_path / "pairs.txt"
    pairs.write_text(f"{tgt}\n\n{src}\n{tmp_path}/missing.ply\n{src}\n"
                     f"{tgt}\n{tgt}\n")
    capsys.readouterr()
    got = tcli._read_pairs(str(pairs))
    got_err = capsys.readouterr().err
    want = jcli._read_pairs(str(pairs))
    want_err = capsys.readouterr().err
    assert got == want == [(tgt, src), (src, tgt)]
    assert got_err == want_err and "missing.ply" in got_err
