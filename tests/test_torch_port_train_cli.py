"""The port's training state and training CLI, on the CPU at small sizes.

`python -m simpb_tpu_torch.tools.train` runs in process (`main`) with
`--config tiny --device cpu` over a fake nuScenes-format pkl with PNG
images, 2D GT and LiDAR files: 3 iterations with a checkpoint every 2,
a mid-training eval and `ckpt_best` at 3, the backbone from a
torchvision-named `.pth` and more weights from a reference-named `.pth`
(both written here); then a second run resumed from `ckpt_2` to 3. On
those runs: the files and log lines; the resumed stream equals the
uninterrupted one exactly (the loss, every parameter and BatchNorm
buffer, the Adam moments, the temporal and DN state and the host poses,
`torch.equal`), the port's counterpart of
tests/test_checkpoint_resume.py::test_resumed_stream_matches_uninterrupted;
a checkpoint read back into fresh templates equals the state it saved;
the eval CLI reads the trainer's checkpoint. Then the watchdog's forced
exit 75 with its marker and its stand-down for a healthy loop (a short
`python -c` subprocess blocked in `native_hang`, as tests/test_watchdog.py
does), every "not ported" refusal, the refusal to run without a card
when no device is named, and `load_pretrained_backbone` and the
training model's `load_torch_checkpoint` against the JAX package's
(`from_jax_variables` of the JAX trees merged over the model's own).
"""
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from simpb_tpu.configs import base as jax_base
from simpb_tpu.utils import torch_convert as jax_tc
from simpb_tpu_torch.configs.base import TrainConfig
from simpb_tpu_torch.models.detector import SimPB
from simpb_tpu_torch.tools import test as test_cli
from simpb_tpu_torch.tools import train as train_cli
from simpb_tpu_torch.training import checkpoint
from simpb_tpu_torch.training.train_step import (
    build_train_model, create_train_state, init_temporal,
)
from simpb_tpu_torch.utils import torch_convert
from simpb_tpu_torch.utils.convert import from_jax_variables, to_jax_variables
from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_H, SRC_W = 80, 160  # the CLI's 0.40-0.47 resize covers 64x32


def _tiny():
    return train_cli.build_config(train_cli.parse_args(
        ["--ann-file", "x", "--config", "tiny"]))


def _backbone_pth(path, cfg, layout, seed=0):
    """A `.pth` of random backbone weights under one of the three naming
    layouts (torchvision with a classifier, mmdet `backbone.*` in a
    `state_dict` wrapper, `img_backbone.*`); returns the flat dict
    written (torchvision names, numpy)."""
    rng = np.random.default_rng(seed)
    tree = to_jax_variables(SimPB(cfg))
    sd = {}
    for t, f, kind in jax_tc.build_mapping(cfg):
        if not t.startswith("img_backbone."):
            continue
        node = tree["params"]
        for k in f:
            node = node[k]
        name = t[len("img_backbone."):]
        if kind == "conv":
            shape = np.asarray(node["kernel"]).shape
            sd[f"{name}.weight"] = rng.normal(size=(shape[3], shape[2],
                                                    *shape[:2]))
        else:
            n = np.asarray(node["scale"]).shape[0]
            sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, n)
            sd[f"{name}.bias"] = rng.normal(size=n)
            sd[f"{name}.running_mean"] = rng.normal(size=n)
            sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, n)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    prefix = {"torchvision": "", "mmdet": "backbone.",
              "img_backbone": "img_backbone."}[layout]
    out = {prefix + k: torch.from_numpy(v) for k, v in sd.items()}
    if layout == "torchvision":
        out["fc.weight"] = torch.zeros(10, 2048)
    torch.save({"state_dict": out} if layout == "mmdet" else out, path)
    return sd


def _head_pth(path, cfg, seed=1):
    """A reference-named `.pth` of a few training-only leaves (the depth
    branch, an intermediate refine3d layer's class branch) and a head
    layer norm; returns it."""
    rng = np.random.default_rng(seed)
    order = cfg.head.operation_order
    first = order.index("refine3d")
    c = cfg.head.embed_dims
    sd = {
        "depth_branch.depth_layers.0.weight": rng.normal(size=(1, c, 1, 1)),
        "depth_branch.depth_layers.0.bias": rng.normal(size=(1,)),
        f"head.layers.{first}.cls_layers.6.weight":
            rng.normal(size=(cfg.head.num_classes, c)),
        f"head.layers.{first}.cls_layers.6.bias":
            rng.normal(size=(cfg.head.num_classes,)),
        f"head.layers.{order.index('norm')}.weight": rng.normal(size=(c,)),
        f"head.layers.{order.index('norm')}.bias": rng.normal(size=(c,)),
    }
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    torch.save(sd, path)
    return sd


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("train_cli")
    pkl = write_synthetic_infos(str(d), n_frames=8, gap_at=(4,),
                                src_hw=(SRC_H, SRC_W), num_objects=8,
                                write_images=True, with_2d=True,
                                with_lidar=True)
    cfg = _tiny()
    _backbone_pth(str(d / "resnet.pth"), cfg, "torchvision")
    _head_pth(str(d / "ref.pth"), cfg)
    common = ["--ann-file", pkl, "--config", "tiny", "--device", "cpu",
              "--batch-size", "1", "--max-iters", "3", "--log-interval",
              "1", "--ckpt-interval", "2", "--src-h", str(SRC_H),
              "--src-w", str(SRC_W)]
    saved_tb = os.environ.get("SIMPB_NO_TB")
    os.environ["SIMPB_NO_TB"] = "1"
    try:
        log = io.StringIO()
        with redirect_stdout(log):
            first = train_cli.main(common + [
                "--work-dir", str(d / "work"), "--eval-ann-file", pkl,
                "--eval-interval", "3", "--eval-frames", "4",
                "--pretrained-backbone", str(d / "resnet.pth"),
                "--load-from", str(d / "ref.pth")])
            second = train_cli.main(common + [
                "--work-dir", str(d / "work2"),
                "--resume-from", str(d / "work" / "ckpt_2")])
    finally:
        if saved_tb is None:
            del os.environ["SIMPB_NO_TB"]
        else:
            os.environ["SIMPB_NO_TB"] = saved_tb
    return dict(dir=d, pkl=pkl, cfg=cfg, first=first, second=second,
                log=log.getvalue())


def test_cli_trains_checkpoints_and_evaluates(cli_runs):
    r, d = cli_runs["first"], cli_runs["dir"]
    assert sorted(os.listdir(d / "work")) == ["ckpt_2", "ckpt_3",
                                              "ckpt_best"]
    assert sorted(os.listdir(d / "work2")) == ["ckpt_3"]
    log = cli_runs["log"]
    for line in ("iter 1/3 loss ", "iter 3/3 loss ", "saved ",
                 "eval @ iter 3: ", "new best NDS ",
                 "resumed from ", "at iter 2"):
        assert line in log, line
    assert sorted(r["losses"]) == [1, 2, 3]
    assert all(np.isfinite(v) for ld in r["losses"].values()
               for v in ld.values())
    assert {"loss", "loss_dense_depth", "loss_cls3d_5",
            "loss_cls2d_dn_2"} <= set(r["losses"][1])
    assert r["evals"][0]["frames"] == 4 and "NDS" in r["evals"][0]["metrics"]
    assert r["best_score"] == r["evals"][0]["metrics"]["NDS"]
    assert r["route_counts"] == {"native": 3, "pil": 0}
    assert len(r["producer_ms"]) == len(r["queue_wait_ms"]) == 3
    assert [c["bytes"] > 0 for c in r["checkpoints"]] == [True] * 3
    assert cli_runs["second"]["start_iter"] == 2


def _state_diff(got, want):
    """Names of the entries of two runs' final states that differ."""
    bad = []
    sg = got["state"].model.state_dict()
    for k, v in want["state"].model.state_dict().items():
        if not torch.equal(sg[k], v):
            bad.append(k)
    for n, (mu, nu) in want["state"].opt_state.items():
        gm, gn = got["state"].opt_state[n]
        if not (torch.equal(gm, mu) and torch.equal(gn, nu)):
            bad.append(f"opt_state.{n}")
    if got["state"].step != want["state"].step:
        bad.append("step")
    for kind in ("temporal", "dn_state"):
        for f in dataclasses.fields(want[kind]):
            if not torch.equal(getattr(got[kind], f.name),
                               getattr(want[kind], f.name)):
                bad.append(f"{kind}.{f.name}")
    for g, w in zip(got["prev_pose"], want["prev_pose"]):
        if (g is None) != (w is None) or (w is not None and not (
                g[0] == w[0] and np.array_equal(g[1], w[1]))):
            bad.append("prev_pose")
    return bad


def test_resumed_stream_matches_uninterrupted(cli_runs):
    first, second = cli_runs["first"], cli_runs["second"]
    assert second["losses"][3] == first["losses"][3]
    assert _state_diff(second, first) == []
    assert second["state"].step == 3


def test_checkpoint_round_trip_is_exact(cli_runs):
    """`ckpt_best` (written after the eval at iteration 3) read back into
    fresh templates equals the run's final state, tensor for tensor."""
    cfg, first = cli_runs["cfg"], cli_runs["first"]
    model = build_train_model(cfg, device="cpu", seed=5)
    state = create_train_state(model, TrainConfig(batch_size=1))
    temporal, dn_state = init_temporal(cfg, 1, "cpu")
    state, temporal, dn_state, pose, it, best = checkpoint.restore_checkpoint(
        str(cli_runs["dir"] / "work" / "ckpt_best"), state, temporal,
        dn_state)
    got = dict(state=state, temporal=temporal, dn_state=dn_state,
               prev_pose=pose)
    assert _state_diff(got, first) == []
    assert it == 3 and best == first["best_score"]
    # another batch size's templates are refused
    t2, d2 = init_temporal(cfg, 2, "cpu")
    with pytest.raises(ValueError, match="temporal"):
        checkpoint.restore_checkpoint(
            str(cli_runs["dir"] / "work" / "ckpt_best"), state, t2, d2)


@pytest.fixture(scope="module")
def small_trunk():
    cfg = dataclasses.replace(_tiny(), backbone_depth=26)
    return cfg, SimPB(cfg, train=True)


def test_checkpoint_keeps_every_field(tmp_path, small_trunk):
    """Poses with empty slots, no best score and a missing DN state
    round-trip as they were saved."""
    cfg = small_trunk[0]
    model = build_train_model(cfg, device="cpu", seed=0)
    state = create_train_state(model, TrainConfig(batch_size=2))
    state.step = 7
    with torch.no_grad():
        for mu, nu in state.opt_state.values():
            mu.normal_()
            nu.uniform_()
    temporal, _ = init_temporal(cfg, 2, "cpu")
    temporal = temporal.replace(prev_id=torch.tensor([3, 9],
                                                     dtype=torch.int32))
    pose = [(1.5e9 + 0.25, np.arange(16.0).reshape(4, 4)), None]
    size = checkpoint.save_checkpoint(str(tmp_path / "c"), state, temporal,
                                      None, pose)
    assert size == os.path.getsize(tmp_path / "c")
    fresh = create_train_state(build_train_model(cfg, device="cpu", seed=1),
                               TrainConfig(batch_size=2))
    t0, d0 = init_temporal(cfg, 2, "cpu")
    fresh, t1, d1, p1, it, best = checkpoint.restore_checkpoint(
        str(tmp_path / "c"), fresh, t0, d0)
    assert it == 7 and best is None and d1 is None
    assert torch.equal(t1.prev_id, temporal.prev_id)
    assert p1[1] is None and p1[0][0] == pose[0][0]
    assert np.array_equal(p1[0][1], pose[0][1])
    for n, (mu, nu) in state.opt_state.items():
        assert torch.equal(fresh.opt_state[n][0], mu)
        assert torch.equal(fresh.opt_state[n][1], nu)
    with pytest.raises(ValueError, match="not a checkpoint"):
        torch.save({"model": {}}, tmp_path / "other")
        checkpoint.restore_checkpoint(str(tmp_path / "other"), fresh, t0, d0)


def test_eval_cli_reads_the_trainers_checkpoint(cli_runs, monkeypatch):
    from simpb_tpu_torch.training import evaluate

    seen = {}

    def fake_eval(model, cfg, dataset, **kw):
        seen["state"] = model.state_dict()
        return {"mAP": 0.0, "NDS": 0.0}, [], []

    monkeypatch.setattr(evaluate, "streaming_eval", fake_eval)
    ckpt = cli_runs["dir"] / "work" / "ckpt_3"
    test_cli.main(["--ann-file", cli_runs["pkl"], "--config", "tiny",
                   "--device", "cpu", "--src-h", str(SRC_H),
                   "--src-w", str(SRC_W), "--checkpoint", str(ckpt)])
    trained = checkpoint.load_model_state(str(ckpt))
    assert len(seen["state"]) > 100
    for k, v in seen["state"].items():
        assert torch.equal(v, trained[k]), k


NOT_PORTED = [["--multihost"], ["--coordinator", "host:1234"],
              ["--num-processes", "2"], ["--process-id", "0"],
              ["--img-bf16"], ["--config", "r50"], ["--config", "r101"],
              ["--config", "r101-fast"]]


def _accepted(monkeypatch, argv):
    """Run the CLI's `main` on `argv` with `run` replaced by a recorder:
    the configuration it would train."""
    configs = []
    monkeypatch.setattr(train_cli, "run", lambda args: configs.append(
        train_cli.build_config(args)))
    train_cli.main(argv)
    (cfg,) = configs
    return cfg


# the multi-process flags, served since data-parallel training landed:
# what `initialize_multihost` is called with when each is given with
# --multihost (coordinator, processes, process id)
MULTIHOST = {"--multihost": (None, None, None),
             "--coordinator": ("host:1234", None, None),
             "--num-processes": (None, 2, None),
             "--process-id": (None, None, 0)}


@pytest.mark.parametrize("extra", NOT_PORTED,
                         ids=[" ".join(a) for a in NOT_PORTED])
def test_train_cli_refuses(extra, monkeypatch):
    """Every flag the port does not train exits with "not ported"
    (`--img-bf16`). Served: `--config r50` since
    the exact MSDA backward (kernel D) landed (the CLI takes it, no run
    here; exact MSDA, the JAX CLI's config), `r101` and `r101-fast`
    since ResNet-101 and the space-to-depth stem landed (the JAX CLI's
    configs, trunk bf16), and the multi-process
    flags since data-parallel training landed: with `--multihost` the
    CLI joins the process group with them before it trains (no group is
    made here), and leaves it after."""
    from simpb_tpu_torch.parallel import mesh

    argv = ["--ann-file", "none.pkl", "--device", "cpu"]
    if "--config" not in extra:
        argv += ["--config", "tiny"]
    if extra[0] in MULTIHOST:
        joined, left = [], []
        monkeypatch.setattr(mesh, "initialize_multihost",
                            lambda *a, **k: joined.append((a, k))
                            or torch.device("cpu"))
        monkeypatch.setattr(mesh, "shutdown", lambda: left.append(1))
        more = [] if extra == ["--multihost"] else ["--multihost"]
        cfg = _accepted(monkeypatch, argv + extra + more)
        assert joined == [(MULTIHOST[extra[0]], {"device": "cpu"})]
        assert left == [1] and cfg.backbone_depth == 50
        return
    served = {"r50": "simpb_r50_704x256", "r101": "simpb_r101_1408x512",
              "r101-fast": "simpb_r101_1408x512_fast"}
    if extra[0] == "--config" and extra[1] in served:
        cfg = _accepted(monkeypatch, argv + extra)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            dataclasses.replace(getattr(jax_base, served[extra[1]])(),
                                compute_dtype="bfloat16"))
        return
    with pytest.raises(SystemExit) as exc:
        train_cli.main(argv + extra)
    msg = str(exc.value.code)
    assert "not ported" in msg and extra[0] in msg


def test_train_cli_default_config_is_refused(monkeypatch):
    """The default `--config r50`, exact MSDA, is no longer refused: the
    CLI takes it."""
    cfg = _accepted(monkeypatch, ["--ann-file", "none.pkl", "--device",
                                  "cpu"])
    assert not cfg.head.msda_patch_mode and cfg.backbone_depth == 50


def test_train_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--ann-file", "none.pkl", "--config", "tiny"])


UNIT_SCRIPT = r"""
import sys, time
from simpb_tpu_torch.utils.watchdog import PreemptionWatchdog
from simpb_tpu_torch.data.native_preprocess import native_hang

wd = PreemptionWatchdog(deadline_s=1.0, work_dir={work!r},
                        poll_s=0.05).arm()
wd.record_checkpoint("/ckpt/step_40")
wd.heartbeat(step=40)
print("armed", flush=True)
if sys.argv[1] == "stall":
    assert native_hang(60.0), "native library unavailable"
    print("hang returned", flush=True)
    sys.exit(9)
import signal
stop = []
signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
for _ in range(200):
    time.sleep(0.05)
    wd.heartbeat()
    if stop:
        wd.acknowledge()
        print("graceful exit", flush=True)
        sys.exit(0)
sys.exit(8)
"""


def _watchdog_unit(tmp_path, mode):
    from simpb_tpu_torch.data.native_preprocess import available

    assert available()  # built here, so the child does not compile
    work = str(tmp_path / f"wd_{mode}")
    proc = subprocess.Popen(
        [sys.executable, "-c", UNIT_SCRIPT.format(work=work), mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    t0 = time.time()
    line = proc.stdout.readline()
    assert "armed" in line, line
    time.sleep(0.3)  # let the stall or the loop start
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    return proc.returncode, out, work, time.time() - t0


def test_watchdog_forces_resumable_exit_during_native_stall(tmp_path):
    rc, out, work, wall = _watchdog_unit(tmp_path, "stall")
    assert rc == 75, (rc, out)
    assert "forcing" in out and "Recovery point" in out, out
    assert wall < 30, wall  # far sooner than the 60 s hang
    with open(os.path.join(work, "WATCHDOG_EXIT.json")) as f:
        rec = json.load(f)
    assert rec["exit_code"] == 75 and rec["signal"] == int(signal.SIGTERM)
    assert rec["last_completed_checkpoint"] == "/ckpt/step_40"
    assert rec["last_completed_step"] == 40


def test_watchdog_stands_down_for_healthy_loop(tmp_path):
    rc, out, work, _ = _watchdog_unit(tmp_path, "healthy")
    assert rc == 0 and "graceful exit" in out, (rc, out)
    assert not os.path.exists(os.path.join(work, "WATCHDOG_EXIT.json"))


@pytest.mark.parametrize("layout", ["torchvision", "mmdet", "img_backbone"])
def test_load_pretrained_backbone_matches_jax(small_trunk, tmp_path, layout):
    cfg, model = small_trunk
    path = str(tmp_path / "bb.pth")
    _backbone_pth(path, cfg, layout, seed=2)
    got = torch_convert.load_pretrained_backbone(path, cfg, model)
    params, stats = jax_tc.load_pretrained_backbone(path, cfg)
    base = to_jax_variables(model)
    want = from_jax_variables({
        "params": jax_tc.merge_params(base["params"], params),
        "batch_stats": jax_tc.merge_params(base["batch_stats"], stats)},
        cfg, train=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mine = model.state_dict()
    changed = {k for k in want if not torch.equal(want[k], mine[k])}
    assert changed and all(k.startswith("img_backbone.") for k in changed)
    torch.save({"fc.weight": torch.zeros(3, 3)}, tmp_path / "none.pth")
    with pytest.raises(ValueError, match="no backbone parameters"):
        torch_convert.load_pretrained_backbone(str(tmp_path / "none.pth"),
                                               cfg, model)


def test_load_from_into_the_training_model_matches_jax(small_trunk,
                                                       tmp_path):
    cfg, model = small_trunk
    path = str(tmp_path / "ref.pth")
    _head_pth(path, cfg)
    got = torch_convert.load_torch_checkpoint(path, cfg, model)
    params, stats = jax_tc.load_torch_checkpoint(path, cfg)
    base = to_jax_variables(model)
    want = from_jax_variables({
        "params": jax_tc.merge_params(base["params"], params),
        "batch_stats": jax_tc.merge_params(base["batch_stats"], stats)},
        cfg, train=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["depth_branch.depth_layer_0.bias"],
                       torch.load(path)["depth_branch.depth_layers.0.bias"])
    model.load_state_dict(got, strict=True)
