"""The port's evaluation and measurement entry points against the JAX
package, on the CPU at small sizes.

Held equal to their JAX counterparts on the same numpy-seeded inputs:
the test-mode data pipeline over a fake nuScenes-format infos pkl with
small PNG images (`img`, `projection_mat`, `timestamp`, `lidar2global`,
`ego2global` bit for bit, on the native C++ path and on the PIL path),
`get_annotations`, `sequence_eval_shards`, `boxes_lidar_to_global`,
`format_nuscenes_submission`, and the two scorers (the same keys, values
within 1e-12). Then the CLIs: `simpb_tpu_torch.tools.test` over the fake
set on the CPU (windowed and exact MSDA), `run_benchmark` on the CPU,
`simpb_tpu_torch.bench`'s line, the configurations the CLI and the bench
serve (each equal, field by field, to the JAX configuration its switch
selects), the CLI's exit on a guard violation, and every setting the
port refuses as "not ported". No JAX model is compiled here; the
whole-path parity of `streaming_eval` lives in
tests/test_torch_port_slice.py, which reuses its compiled steps, and the
exact path's in tests/test_torch_port_exact.py.
"""
import dataclasses
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from simpb_tpu.data import nuscenes_eval as jax_det
from simpb_tpu.data import postprocess as jax_post
from simpb_tpu.data import sampler as jax_sampler
from simpb_tpu.data import tracking_eval as jax_trk
from simpb_tpu.configs import base as jax_base
from simpb_tpu.data.dataset import NuScenesDataset as JaxDataset
from simpb_tpu_torch.configs.base import CLASS_NAMES, simpb_tiny
from simpb_tpu_torch.data import native_preprocess, nuscenes_eval
from simpb_tpu_torch.data import postprocess, sampler, tracking_eval
from simpb_tpu_torch.data.dataset import NuScenesDataset
from simpb_tpu_torch.tools import test as test_cli
from simpb_tpu_torch.tools import train as train_cli
from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_H, SRC_W = 60, 100
N_FRAMES = 6


def _tiny():
    """simpb_tiny as the port's CLI serves it (windowed MSDA)."""
    cfg = simpb_tiny()
    return dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, msda_patch_mode=True))


@pytest.fixture(scope="module")
def fake_set(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("fake_nuscenes")
    pkl = write_synthetic_infos(str(d), n_frames=N_FRAMES, gap_at=(3,),
                                src_hw=(SRC_H, SRC_W), num_objects=8,
                                write_images=True)
    return pkl, test_cli.eval_aug_conf(_tiny(), SRC_H, SRC_W)


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_get_sample_matches_jax(fake_set, native):
    pkl, aug = fake_set
    kw = dict(test_mode=True, data_aug_conf=aug, sequences_split_num=1,
              use_native=native)
    jds, tds = JaxDataset(pkl, **kw), NuScenesDataset(pkl, **kw)
    assert native_preprocess.available()
    for idx in range(N_FRAMES):
        j = jds.get_sample(idx, with_points=False)
        t = tds.get_sample(idx)
        for key in ("img", "projection_mat", "lidar2global", "ego2global",
                    "focal"):
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        assert t["timestamp"] == j["timestamp"]
        assert t["img"].shape == (6, 32, 64, 3)
        assert t["aug_config"] == j["aug_config"]


def test_annotations_and_flags_match_jax(fake_set):
    pkl, aug = fake_set
    kw = dict(test_mode=True, data_aug_conf=aug)
    jds, tds = JaxDataset(pkl, **kw), NuScenesDataset(pkl, **kw)
    for split in (1, 2):
        np.testing.assert_array_equal(tds._sequence_flags(split),
                                      jds._sequence_flags(split))
    for idx in range(N_FRAMES):
        j, t = jds.get_annotations(idx), tds.get_annotations(idx)
        assert sorted(t) == sorted(j)
        for key in t:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_native_preprocess_refuses_other_shapes(fake_set):
    """A grey or RGBA image would be read past its end by the C pass."""
    aug = NuScenesDataset(fake_set[0], data_aug_conf=fake_set[1]) \
        .get_augmentation()
    for shape in ((SRC_H, SRC_W), (SRC_H, SRC_W, 4)):
        with pytest.raises(ValueError, match="expected an"):
            native_preprocess.preprocess_image(np.zeros(shape, np.uint8),
                                               aug)


def test_training_side_not_ported(fake_set):
    """What of the training side is still not ported is refused as "not
    ported" (`--img-bf16`; ResNet-101 trains since A.5's second item
    landed); the multi-process run is served since data-parallel
    training landed: `--multihost` without a launcher's environment or
    a coordinator raises the
    rendezvous's error, and never trains alone. The training-mode
    dataset is ported (tests/test_torch_port_train_data.py holds it to
    JAX): it builds, and without a generator its augmentation is the
    fixed test-mode one."""
    pkl, aug = fake_set
    for extra in (["--img-bf16"],):
        with pytest.raises(SystemExit, match="not ported"):
            train_cli.main(["--ann-file", pkl, "--config", "tiny",
                            "--device", "cpu"] + extra)
    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "RANK")
           if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="torchrun"):
            train_cli.main(["--ann-file", pkl, "--config", "tiny",
                            "--device", "cpu", "--multihost"])
    finally:
        os.environ.update(env)
    train = NuScenesDataset(pkl, test_mode=False, data_aug_conf=aug)
    assert train.get_augmentation() == NuScenesDataset(
        pkl, test_mode=True, data_aug_conf=aug).get_augmentation()


@pytest.mark.parametrize("world_size", [1, 2, 3])
def test_sequence_eval_shards_match_jax(world_size):
    rng = np.random.default_rng(world_size)
    steps = np.where(rng.uniform(size=40) < 0.15, 9.0, 0.5)  # scene gaps
    ts = 1.5e9 + np.cumsum(steps)
    ds = SimpleNamespace(data_infos=[{"timestamp": t * 1e6} for t in ts])
    got = sampler.sequence_eval_shards(ds, world_size)
    assert got == jax_sampler.sequence_eval_shards(ds, world_size)
    assert sorted(i for s in got for i in s) == list(range(40))


def _decoded(rng, n):
    boxes = rng.normal(size=(n, 10)).astype(np.float32) * 10
    return dict(boxes_3d=boxes,
                scores_3d=rng.uniform(size=n).astype(np.float32),
                labels_3d=rng.integers(0, len(CLASS_NAMES), n),
                instance_ids=rng.integers(0, 50, n),
                valid=rng.uniform(size=n) < 0.8)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(3)
    l2g = np.eye(4)
    c, s = np.cos(0.7), np.sin(0.7)
    l2g[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    l2g[:3, 3] = [100.0, -50.0, 1.0]
    boxes = rng.normal(size=(20, 10)).astype(np.float32)
    got = postprocess.boxes_lidar_to_global(boxes, l2g)
    want = jax_post.boxes_lidar_to_global(boxes, l2g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    results = [_decoded(rng, 15) for _ in range(3)]
    tokens = ["a", "b", "c"]
    for tracking in (False, True):
        got = postprocess.format_nuscenes_submission(results, tokens,
                                                     tracking=tracking)
        assert got == jax_post.format_nuscenes_submission(
            results, tokens, tracking=tracking)
        json.dumps(got)


def _scored_frames(seed=0, frames=8, scenes=2):
    """Per frame: GT boxes with persistent ids, and predictions that are
    perturbed copies (0-3 m off, so matches depend on the threshold)
    plus false positives, with random scores."""
    rng = np.random.default_rng(seed)
    preds, gts, scene_ids = [], [], []
    for f in range(frames):
        sid = f * scenes // frames
        n = 10
        labels = np.arange(n) % len(CLASS_NAMES)
        boxes = np.zeros((n, 10), np.float32)
        boxes[:, :2] = rng.uniform(-30, 30, (n, 2))
        boxes[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        boxes[:, 7:9] = rng.normal(size=(n, 2))
        ids = np.arange(n) + 100 * sid
        keep = rng.uniform(size=n) < 0.8
        pb = boxes[keep].copy()
        pb[:, :2] += rng.normal(size=(keep.sum(), 2)) * 1.5
        pb[:, 3:6] *= rng.uniform(0.8, 1.2, (keep.sum(), 3))
        pb[:, 6:9] += rng.normal(size=(keep.sum(), 3)) * 0.3
        fp = np.zeros((4, 10), np.float32)
        fp[:, :2] = rng.uniform(-30, 30, (4, 2))
        fp[:, 3:6] = 1.0
        pboxes = np.concatenate([pb, fp]).astype(np.float32)
        plabels = np.concatenate([labels[keep], rng.integers(0, 10, 4)])
        pids = np.concatenate([ids[keep], 900 + np.arange(4)])
        ego = rng.uniform(-2, 2, 2).astype(np.float32)
        preds.append(dict(boxes=pboxes, labels=plabels, track_ids=pids,
                          scores=rng.uniform(size=len(pboxes))
                          .astype(np.float32), ego_xy=ego))
        gts.append(dict(boxes=boxes, labels=labels, track_ids=ids,
                        ego_xy=ego))
        scene_ids.append(sid)
    return preds, gts, scene_ids


def _same_metrics(got, want):
    assert list(got) == list(want)
    for k in want:
        if math.isnan(want[k]):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_scorers_match_jax():
    preds, gts, scene_ids = _scored_frames()
    got = nuscenes_eval.evaluate_detections(preds, gts)
    want = jax_det.evaluate_detections(preds, gts)
    _same_metrics(got, want)
    assert 0.0 < want["mAP"] < 1.0
    got = tracking_eval.evaluate_tracking(preds, gts, scene_ids)
    want = jax_trk.evaluate_tracking(preds, gts, scene_ids)
    _same_metrics(got, want)
    assert 0.0 < want["AMOTA"] < 1.0


# each flag the CLI refuses (None), or a configuration it now serves: the
# JAX configuration that `--config` selects
NOT_PORTED_ARGS = [
    (["--cam-shards", "2"], None),
    (["--show-dir", "vis"], "simpb_r50_704x256"),
    (["--multihost"], "simpb_r50_704x256"),
    (["--gather-dir", "gather"], "simpb_r50_704x256"),
    (["--config", "r50"], "simpb_r50_704x256"),
    (["--config", "r50-guarded"], "simpb_r50_704x256_guarded"),
    (["--config", "r50-fast-guarded"], "simpb_r50_704x256_fast_guarded"),
    (["--config", "r50-hybrid"], "simpb_r50_704x256_hybrid"),
    (["--config", "r101-fast"], "simpb_r101_1408x512_fast"),
    (["--config", "r101"], "simpb_r101_1408x512"),
]


def _fake_eval(monkeypatch, metrics):
    """Replace the CLI's model build and stream by recorders: nothing is
    built; the stream returns `metrics`. Returns the served configs."""
    from simpb_tpu_torch.training import evaluate

    served = []
    monkeypatch.setattr(evaluate, "build_model",
                        lambda cfg, device=None, seed=0: served.append(cfg))
    monkeypatch.setattr(evaluate, "streaming_eval",
                        lambda model, cfg, dataset, **kw: (dict(metrics), [],
                                                           []))
    return served


@pytest.mark.parametrize("extra,served", NOT_PORTED_ARGS,
                         ids=[" ".join(a) for a, _ in NOT_PORTED_ARGS])
def test_test_cli_refuses(fake_set, monkeypatch, extra, served):
    """Every flag the port does not serve exits with "not ported"
    (`--cam-shards` > 1 naming ROADMAP A.5). `--show-dir` is served
    since the rendering landed (held to JAX's in
    tests/test_torch_port_tools.py). The
    configurations it serves run (no model built here): the config equals
    the JAX CLI's of that name, field by field, trunk bf16 and the fused
    trunk (`--fused-trunk`; under `stem_s2d`, `r101-fast`, the detector
    takes the module trunk by JAX's rule), and `check_serving_config`
    accepts it. `--multihost` and
    `--gather-dir` are served since the multi-process eval landed: with
    `--multihost` the CLI joins the process group first and leaves it
    after (no group is made here, so the world is 1 and the one stream
    runs); `--gather-dir` at world 1 changes nothing."""
    from simpb_tpu_torch.models.detector import check_serving_config
    from simpb_tpu_torch.parallel import mesh

    argv = ["--ann-file", fake_set[0], "--device", "cpu"] + extra
    if served is None:
        with pytest.raises(SystemExit) as exc:
            test_cli.main(argv)
        assert "not ported" in str(exc.value.code)
        if extra[0] == "--cam-shards":
            assert "ROADMAP A.5" in str(exc.value.code)
        return
    joined, left = [], []
    monkeypatch.setattr(mesh, "initialize_multihost",
                        lambda *a, **k: joined.append((a, k))
                        or torch.device("cpu"))
    monkeypatch.setattr(mesh, "shutdown", lambda: left.append(1))
    configs = _fake_eval(monkeypatch, {"mAP": 0.0})
    assert test_cli.main(argv) == {"mAP": 0.0}
    multihost = extra == ["--multihost"]
    assert joined == ([((None, None, None), {"device": "cpu"})]
                      if multihost else [])
    assert left == ([1] if multihost else [])
    (cfg,) = configs
    want = dataclasses.replace(getattr(jax_base, served)(),
                               compute_dtype="bfloat16",
                               backbone_fused_infer=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    check_serving_config(cfg)


def test_test_cli_multi_process_dispatch(fake_set, monkeypatch, tmp_path,
                                        capsys):
    """With more than one process the CLI streams its shard through
    `distributed_streaming_eval` into `--gather-dir` (required); rank 0
    prints the metrics and exits 3 on a guard violation, the other ranks
    return after writing their shard; `--cam-shards` stays refused. One
    process with several cards and no `--device` takes one shard a card
    (`multidevice_streaming_eval`). No model is built, no group made."""
    from simpb_tpu_torch.parallel import mesh
    from simpb_tpu_torch.training import evaluate

    _fake_eval(monkeypatch, {"mAP": 0.0})
    calls = []

    def dist_eval(model, cfg, dataset, tmpdir, **kw):
        calls.append(tmpdir)
        return results.pop(0)

    monkeypatch.setattr(evaluate, "distributed_streaming_eval", dist_eval)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    argv = ["--ann-file", fake_set[0], "--device", "cpu"]
    with pytest.raises(SystemExit, match="--gather-dir"):
        test_cli.main(argv)
    with pytest.raises(SystemExit, match="not ported"):
        test_cli.main(argv + ["--cam-shards", "2"])
    gather = str(tmp_path / "gather")
    results = [None, ({"mAP": 0.5}, [], []),
               ({"mAP": 0.5, "guard_dfa_overflow": 1.0}, [], [])]
    assert test_cli.main(argv + ["--gather-dir", gather]) is None
    capsys.readouterr()
    assert test_cli.main(argv + ["--gather-dir", gather]) == {"mAP": 0.5}
    assert '"mAP": 0.5' in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        test_cli.main(argv + ["--config", "r50-guarded", "--gather-dir",
                              gather])
    assert exc.value.code == 3 and calls == [gather] * 3

    monkeypatch.setattr(mesh, "process_count", lambda: 1)
    monkeypatch.setattr(test_cli, "_cards", lambda: 2)
    monkeypatch.setattr(evaluate, "multidevice_streaming_eval",
                        lambda model, cfg, dataset, **kw: ({"mAP": 0.25},
                                                           [], []))
    assert test_cli.main(argv) == {"mAP": 0.0}  # a device was named
    assert test_cli.main(argv[:2]) == {"mAP": 0.25}


def test_decode_to_host_takes_broadcast_guards():
    """The one host copy of a decode: the first sample or the whole
    batch, each value as it was, a guard maximum broadcast to [bs]
    (stride 0) among them."""
    from simpb_tpu_torch.training import evaluate

    dec = {"boxes_3d": torch.arange(12.0).reshape(2, 3, 2),
           "labels_3d": torch.tensor([[1, 2, 3], [4, 5, 6]],
                                     dtype=torch.int32),
           "valid": torch.tensor([[True, False, True], [False] * 3]),
           "guard_dfa_overflow": torch.tensor(7.0).expand(2)}
    batch = evaluate._decode_batch_to_host(dec)
    first = evaluate._decode_to_host(dec)
    for k, v in dec.items():
        np.testing.assert_array_equal(batch[k], v.numpy())
        np.testing.assert_array_equal(first[k], v[0].numpy())
        assert batch[k].dtype == v.numpy().dtype


def test_test_cli_exits_on_guard_violation(fake_set, monkeypatch, capsys):
    """A nonzero `guard_*` maximum (a frame that left the exact semantics)
    makes the CLI exit 3 after printing the metrics, as the JAX CLI does;
    zero maxima and `*_demand` statistics do not."""
    argv = ["--ann-file", fake_set[0], "--device", "cpu", "--config",
            "r50-guarded"]
    _fake_eval(monkeypatch, {"mAP": 0.0, "guard_dfa_overflow": 0.0,
                             "guard_msda_overflow": 2.0})
    with pytest.raises(SystemExit) as exc:
        test_cli.main(argv)
    assert exc.value.code == 3
    assert '"guard_msda_overflow": 2.0' in capsys.readouterr().out
    _fake_eval(monkeypatch, {"mAP": 0.0, "guard_dfa_overflow": 0.0,
                             "guard_msda_clamp_demand": 5.0})
    assert test_cli.main(argv)["guard_msda_clamp_demand"] == 5.0


def test_test_cli_tiny_is_exact(fake_set, monkeypatch):
    """`--config tiny` is JAX's tiny: the 2D cross-attention samples with
    exact MSDA (three layers a frame), never the windowed op."""
    from simpb_tpu_torch.models import group_attn
    from simpb_tpu_torch.ops import sampling

    calls = []
    exact, windowed = group_attn.msda, sampling._msda_patch_sel
    monkeypatch.setattr(group_attn, "msda", lambda *a, **k: (
        calls.append("msda"), exact(*a, **k))[1])
    monkeypatch.setattr(sampling, "_msda_patch_sel", lambda *a, **k: (
        calls.append("window"), windowed(*a, **k))[1])
    metrics = test_cli.main([
        "--ann-file", fake_set[0], "--config", "tiny", "--device", "cpu",
        "--src-h", str(SRC_H), "--src-w", str(SRC_W), "--max-frames", "2"])
    assert {"mAP", "NDS"} <= set(metrics)
    assert calls == ["msda"] * 6


def test_test_cli_runs_on_cpu(fake_set, tmp_path, capsys):
    out = tmp_path / "sub.json"
    metrics = test_cli.main([
        "--ann-file", fake_set[0], "--config", "tiny", "--msda-patch",
        "--device", "cpu", "--src-h", str(SRC_H), "--src-w", str(SRC_W),
        "--tracking", "--out", str(out)])
    printed = capsys.readouterr().out
    assert f"wrote {out}" in printed
    assert {"mAP", "NDS", "AMOTA", "AMOTP"} <= set(metrics)
    sub = json.loads(out.read_text())
    assert sorted(sub["results"]) == [f"tok{i}" for i in range(N_FRAMES)]
    for annos in sub["results"].values():
        for a in annos:
            assert {"tracking_id", "tracking_name", "tracking_score"} <= set(a)


def test_streaming_eval_refuses(monkeypatch, tmp_path):
    """`cam_shards > 1` (ROADMAP A.5) is refused; `show_dir` is served
    (the stream renders its frames, tests/test_torch_port_tools.py); the
    multi-slot and distributed evals are served (held to the bs-1 stream
    and to JAX in tests/test_torch_port_slice.py): one slot is the one
    stream, and the disk gather merges the ranks' parts in rank order
    with their guard maxima."""
    from simpb_tpu_torch.data import sampler
    from simpb_tpu_torch.training import evaluate

    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        evaluate.streaming_eval(None, None, None, cam_shards=2)
    shown = []
    with monkeypatch.context() as m:
        m.setattr(sampler, "sequence_eval_shards", lambda ds, n: [[0, 1]])
        m.setattr(evaluate, "_stream_shard",
                  lambda *a, **k: shown.append(k) or ([], [], [], [], {}))
        m.setattr(evaluate, "_score", lambda *a: {"mAP": 0.0})
        assert evaluate.streaming_eval(
            None, None, None, show_dir="vis", show_threshold=0.5)[0] == {
                "mAP": 0.0}
    assert (shown[0]["show_dir"], shown[0]["show_threshold"]) == ("vis",
                                                                  0.5)
    streamed = []
    monkeypatch.setattr(evaluate, "streaming_eval",
                        lambda *a, **k: streamed.append(k) or "one")
    assert evaluate.multidevice_streaming_eval(
        None, None, None, max_frames=3, devices=["cpu"]) == "one"
    assert streamed[0]["max_frames"] == 3

    def fake_shard(model, cfg, dataset, shard, progress=False):
        rank = shard[0]
        return ([{"rank": rank}], [{"gt": rank}], [0], [f"tok{rank}"],
                {"guard_x": float(rank + 1)})

    scored = []
    monkeypatch.setattr(evaluate, "_stream_shard", fake_shard)
    monkeypatch.setattr(evaluate, "_score", lambda p, g, s, t: scored.append(
        (p, g, s)) or {"mAP": 0.5})
    monkeypatch.setattr(sampler, "sequence_eval_shards",
                        lambda ds, n: [[r] for r in range(n)])
    for rank in (1, 0):
        got = evaluate.distributed_streaming_eval(
            None, None, None, str(tmp_path), world_size=2, rank=rank)
        assert (got is None) == (rank == 1)
    metrics, preds, tokens = got
    assert metrics == {"mAP": 0.5, "guard_x": 2.0}
    assert preds == [{"rank": 0}, {"rank": 1}]
    assert tokens == ["tok0", "tok1"]
    assert scored[0][2] == [(0, 0), (1, 0)]
    assert sorted(os.listdir(tmp_path)) == ["part_0.pkl", "part_1.pkl"]


@pytest.fixture(scope="module")
def cpu_bench():
    """`run_benchmark` of the tiny config on the CPU, window 2."""
    from simpb_tpu_torch.utils.benchmark import run_benchmark

    torch.set_num_threads(1)
    return run_benchmark(_tiny(), window=2, return_stats=True, device="cpu")


def test_run_benchmark_on_cpu(cpu_bench):
    fps, stats = cpu_bench
    assert fps > 0 and stats == {"peak_hbm_bytes": None}


def _jax_bench_keys():
    """The keys of the repository's bench.py line, from its own main with
    its measurement replaced by a constant (nothing is compiled)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.run_benchmark = lambda cfg, **kw: (60.0, {"peak_hbm_bytes": 2 ** 30})
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return list(json.loads(buf.getvalue()))


def test_bench_line_has_jax_keys(monkeypatch, cpu_bench):
    """bench.main, with `run_benchmark` replaced by the tiny CPU run (the
    bench itself has no device switch, like bench.py)."""
    from simpb_tpu_torch import bench

    served = []

    def cpu_run(cfg, window, batch_size, return_stats):
        served.append((cfg, window, batch_size, return_stats))
        return cpu_bench

    monkeypatch.setattr(bench, "run_benchmark", cpu_run)
    buf = io.StringIO()
    with redirect_stdout(buf):
        bench.main()
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == _jax_bench_keys()
    assert line["metric"] == "6cam_frames_per_sec_per_chip"
    assert line["value"] > 0 and line["peak_hbm_gib"] is None
    cfg, window, batch_size, return_stats = served[0]
    assert (window, batch_size, return_stats) == (128, 1, True)
    assert (cfg.compute_dtype, cfg.head_dtype) == ("bfloat16", "bfloat16")
    assert cfg.head.msda_patch_mode and cfg.input_size == (704, 256)


def test_bench_switches(monkeypatch):
    from simpb_tpu_torch import bench

    monkeypatch.setenv("SIMPB_DFA_CAP", "1024")
    monkeypatch.setenv("SIMPB_MSDA_CAP", "192")
    monkeypatch.setenv("SIMPB_FUSED_TRUNK", "1")
    cfg = bench.config()
    assert cfg.head.dfa_gather_capacity == 1024
    assert cfg.head.msda_gather_capacity == 192


def _jax_bench_config(monkeypatch):
    """The config the repository's bench.py serves under the current
    environment, from its own main with its measurement replaced by a
    recorder (nothing is compiled)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []
    mod.run_benchmark = lambda cfg, **kw: (seen.append(cfg), (
        60.0, {"peak_hbm_bytes": None}))[1]
    with redirect_stdout(io.StringIO()):
        mod.main()
    return seen[0]


# each switch the bench refuses (False), or serves (True): then its
# config is bench.py's under the same switch, with the fused trunk but
# under SIMPB_FUSED_TRUNK=0 (the module trunk, as bench.py sets it)
BENCH_REFUSED = [("SIMPB_GUARDED", "1", True),
                 ("SIMPB_FAST_GUARDED", "1", True),
                 ("SIMPB_HYBRID", "1", True), ("SIMPB_EXACT", "1", True),
                 ("SIMPB_CLAMP_CAP", "64", True),
                 ("SIMPB_FUSED_TRUNK", "0", True)]


@pytest.mark.parametrize("name,value,served", BENCH_REFUSED,
                         ids=[n for n, _, _ in BENCH_REFUSED])
def test_bench_refuses(monkeypatch, name, value, served):
    """A switch the port does not serve exits with "not ported" and its
    name; a served one selects bench.py's config, field by field (the
    fused trunk unless SIMPB_FUSED_TRUNK=0 selects the module trunk),
    which `check_serving_config` accepts."""
    from simpb_tpu_torch import bench
    from simpb_tpu_torch.models.detector import check_serving_config

    monkeypatch.setenv(name, value)
    if not served:
        with pytest.raises(SystemExit) as exc:
            bench.config()
        assert "not ported" in str(exc.value.code)
        assert name in str(exc.value.code)
        return
    cfg = bench.config()
    fused = name != "SIMPB_FUSED_TRUNK"
    want = dataclasses.replace(_jax_bench_config(monkeypatch),
                               backbone_fused_infer=fused)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    check_serving_config(cfg)


def test_bench_switch_precedence(monkeypatch):
    """bench.py's precedence: the hybrid wins over `SIMPB_EXACT`, and a
    guarded switch wins over the hybrid; each pair serves bench.py's
    config, field by field, with the fused trunk."""
    from simpb_tpu_torch import bench

    monkeypatch.setenv("SIMPB_HYBRID", "1")
    monkeypatch.setenv("SIMPB_EXACT", "1")
    assert bench.config_name() == "simpb_r50_704x256_hybrid"
    want = dataclasses.replace(_jax_bench_config(monkeypatch),
                               backbone_fused_infer=True)
    assert dataclasses.asdict(bench.config()) == dataclasses.asdict(want)
    assert want.head.msda_hybrid_mode
    monkeypatch.setenv("SIMPB_FAST_GUARDED", "1")
    assert bench.config_name() == "simpb_r50_704x256_fast_guarded"
    cfg = bench.config()
    want = dataclasses.replace(_jax_bench_config(monkeypatch),
                               backbone_fused_infer=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_bench_module_refuses_in_a_process():
    """`python -m simpb_tpu_torch.bench` serves `SIMPB_EXACT`: in a
    process without a card it takes the switch and stops only where it
    needs the card, before it builds anything."""
    env = dict(os.environ, PYTHONPATH=REPO, SIMPB_EXACT="1",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "simpb_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and out.stdout == ""
    assert "not ported" not in out.stderr
