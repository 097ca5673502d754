"""The port's tools against their JAX counterparts on the CPU: the profile
tool (its lines parse), the benchmark CLI on the tiny config, BN folding
(`utils/fuse_bn.py` against JAX's numpy fold, the folded trunk against
the unfolded one, the CLI over a checkpoint), the dataset wrappers
(index maps, flags and infos against JAX's on one infos pkl) and the
rendering (`render_frame` pixel for pixel against JAX's, and the
`show_dir` branch of `streaming_eval`)."""
import json
import re

import numpy as np
import pytest
import torch

from simpb_tpu.data import visualize as jax_vis
from simpb_tpu.data import wrappers as jax_wrappers
from simpb_tpu.data.dataset import NuScenesDataset as JaxDataset
from simpb_tpu.utils.fuse_bn import fuse_backbone_bn as jax_fuse
from simpb_tpu_torch.configs.base import simpb_tiny
from simpb_tpu_torch.data import visualize, wrappers
from simpb_tpu_torch.data.dataset import NuScenesDataset
from simpb_tpu_torch.models.backbone import ResNet
from simpb_tpu_torch.utils.convert import state_from_jax, to_jax_variables
from simpb_tpu_torch.utils.fuse_bn import fuse_backbone_bn
from simpb_tpu_torch.utils.synthetic import synthetic_rig, write_synthetic_infos

SRC_H, SRC_W = 60, 100


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def infos(tmp_path_factory):
    """A fake nuScenes-format set with images: two scenes of three
    frames."""
    d = tmp_path_factory.mktemp("tools_set")
    return write_synthetic_infos(str(d), n_frames=6, gap_at=(3,),
                                 src_hw=(SRC_H, SRC_W), num_objects=8,
                                 write_images=True)


def test_profile_tool_cpu(tmp_path, capsys, monkeypatch):
    """`python -m simpb_tpu_torch.tools.profile --device cpu`, serving the
    tiny config in place of `simpb_r50_704x256`: the total, window, table
    and trace lines parse, the trace is written, and the JSON line holds
    the same numbers (`--train`, `--config r50`'s step, runs on the card
    in chip_smoke.py)."""
    from simpb_tpu_torch.tools import profile

    monkeypatch.setattr(profile, "serve_config", simpb_tiny)
    res = profile.main(["--device", "cpu", "--frames", "1", "--top", "5",
                        "--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    train, unit = False, "frames"
    total = re.fullmatch(rf"total cpu time: ([\d.]+) ms over 1 {unit}",
                         lines[-9])
    window = re.fullmatch(rf"profiled window: ([\d.]+) ms over 1 {unit}",
                          lines[-8])
    assert total and window, lines[-9:-7]
    for ln in lines[-7:-2]:
        assert re.fullmatch(rf"\s*[\d.]+ ms/{unit[:-1]}\s+[\d.]+ "
                            rf"launches/{unit[:-1]}  \S.*", ln), ln
    trace = lines[-2].removeprefix("raw trace: ")
    assert json.load(open(trace))["traceEvents"]
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    assert abs(res["total_cpu_ms"] - float(total[1])) < 0.01
    assert res["mode"] == ("train" if train else "serve")
    assert res["device"] == "cpu" and res["idle_share"] is None


def test_benchmark_cli_tiny(capsys):
    """`python -m simpb_tpu_torch.tools.benchmark --config tiny --device
    cpu`: JAX's JSON keys (and the device), the config JAX's tool builds
    (bf16 trunk and head, the overrides), and the refusal of a window the
    hybrid cannot serve on the card, naming the flag."""
    from simpb_tpu_torch.tools import benchmark

    line = benchmark.main(["--config", "tiny", "--device", "cpu",
                           "--frames", "1", "--dfa-cap", "0"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == line
    assert set(line) == {
        "config", "msda_patch_mode", "msda_hybrid_mode",
        "msda_clamp_capacity", "dfa_gather_capacity",
        "msda_gather_capacity", "msda_sel_levels", "msda_patch_hw",
        "batch_size", "six_cam_fps_per_chip", "peak_hbm_gib", "device"}
    assert line["six_cam_fps_per_chip"] > 0 and line["device"] == "cpu"
    assert line["dfa_gather_capacity"] is None
    args = benchmark.parse_args(["--config", "r50-hybrid", "--msda-window",
                                 "16", "16", "--patch", "--msda-sel", "2"])
    cfg = benchmark.build_config(args)
    assert (cfg.compute_dtype, cfg.head_dtype) == ("bfloat16", "bfloat16")
    assert cfg.head.msda_patch_hw == (16, 16) and cfg.head.msda_patch_mode
    assert cfg.head.msda_sel_levels == 2
    refused = benchmark.refused_flags(args, cfg, torch.device("cuda"))
    assert len(refused) == 1 and refused[0].startswith("--msda-window")
    assert not benchmark.refused_flags(args, cfg, torch.device("cpu"))
    with pytest.raises(SystemExit, match="not ported: --msda-window"):
        benchmark.main(["--config", "r50-hybrid", "--msda-window", "16",
                        "16", "--device", "cuda"])


@pytest.fixture(scope="module")
def trunk_state():
    """A ResNet-50 trunk's state with random BatchNorm statistics and
    affines, so that the fold does something."""
    model = ResNet(50)
    rng = np.random.default_rng(0)
    state = {}
    for k, v in model.state_dict().items():
        if "bn" in k and v.dtype == torch.float32:
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        state[k] = v
    model.load_state_dict(state)
    return model, state


def test_fuse_backbone_bn_matches_jax(trunk_state):
    """The port's fold of the state dict against JAX's numpy fold of the
    converted tree, leaf by leaf within 1e-6."""
    model, state = trunk_state
    tree = to_jax_variables(model)
    params, stats = jax_fuse({"img_backbone": tree["params"]},
                             {"img_backbone": tree["batch_stats"]})
    want = state_from_jax(model, {"params": params["img_backbone"],
                                  "batch_stats": stats["img_backbone"]})
    got = fuse_backbone_bn(state, prefix="")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert not torch.equal(got["conv1.weight"], state["conv1.weight"])


def test_folded_trunk_serves_the_same_frame(trunk_state, tmp_path):
    """A trunk loading the folded state gives the unfolded trunk's maps
    (module trunk at inference, fp32) up to the fold's roundings; the
    CLI folds a checkpoint's model state and keeps the rest."""
    from simpb_tpu_torch.tools import fuse_conv_bn
    from simpb_tpu_torch.training.checkpoint import FORMAT

    model, state = trunk_state
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    folded = ResNet(50)
    folded.load_state_dict(fuse_backbone_bn(state, prefix=""))
    with torch.no_grad():
        ref = model.forward_module(x)
        got = folded.forward_module(x)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   rtol=1e-4)
    ckpt = {"format": FORMAT, "step": 7,
            "model": {f"img_backbone.{k}": v for k, v in state.items()}}
    torch.save(ckpt, tmp_path / "ckpt_7")
    fuse_conv_bn.main(["--checkpoint", str(tmp_path / "ckpt_7"), "--out",
                       str(tmp_path / "fused" / "ckpt_7")])
    out = torch.load(tmp_path / "fused" / "ckpt_7", weights_only=True)
    assert out["step"] == 7 and out["format"] == FORMAT
    want = fuse_backbone_bn(ckpt["model"])
    assert all(torch.equal(out["model"][k], want[k]) for k in want)


def _same_dataset(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.flag, want.flag)
    assert [i["token"] for i in got.data_infos] == \
        [i["token"] for i in want.data_infos]
    for name in ("indices", "cum"):
        if hasattr(want, name):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


def test_wrappers_match_jax(infos):
    """Repeat, Concat and class-balanced wrappers over the port's dataset
    and JAX's on the same pkl: identical index maps, flags and infos, and
    each index reaches the same frame; the samplers take them."""
    from simpb_tpu_torch.data.sampler import group_epoch_indices

    kw = dict(test_mode=False, sequences_split_num=2)
    tds, jds = NuScenesDataset(infos, **kw), JaxDataset(infos, **kw)
    pairs = [
        (wrappers.RepeatDataset(tds, 3), jax_wrappers.RepeatDataset(jds, 3)),
        (wrappers.ConcatDataset([tds, wrappers.RepeatDataset(tds, 2)]),
         jax_wrappers.ConcatDataset([jds,
                                     jax_wrappers.RepeatDataset(jds, 2)])),
        (wrappers.ClassBalancedDataset(tds, seed=3),
         jax_wrappers.ClassBalancedDataset(jds, seed=3)),
        (wrappers.ClassBalancedDataset(wrappers.ConcatDataset([tds, tds])),
         jax_wrappers.ClassBalancedDataset(
             jax_wrappers.ConcatDataset([jds, jds]))),
    ]
    for got, want in pairs:
        _same_dataset(got, want)
        for i in range(len(got)):
            np.testing.assert_array_equal(
                got.get_annotations(i)["gt_labels_3d"],
                want.get_annotations(i)["gt_labels_3d"])
        order = group_epoch_indices(got.flag, 1)
        assert sorted(order.tolist()) == list(range(len(got)))


def _frame_inputs():
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(0, 255, (32, 64, 3)).astype(np.float32)
            for _ in range(6)]
    proj = list(synthetic_rig(1, (64, 32))[0])
    boxes = np.zeros((20, 10), np.float32)
    ang = rng.uniform(-np.pi, np.pi, 20)
    dist = rng.uniform(4, 30, 20)
    boxes[:, 0], boxes[:, 1] = dist * np.cos(ang), dist * np.sin(ang)
    boxes[:, 2] = rng.uniform(-1, 1, 20)
    boxes[:, 3:6] = rng.uniform(1, 4, (20, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 20)
    return imgs, {"boxes_3d": boxes,
                  "scores_3d": rng.uniform(0, 1, 20).astype(np.float32),
                  "labels_3d": rng.integers(0, 10, 20)}, proj


def test_render_frame_matches_jax():
    """`render_frame` pixel for pixel against JAX's (boxes around the car,
    some drawn); without cv2 the rendering raises and names it."""
    imgs, result, proj = _frame_inputs()
    got = visualize.render_frame(imgs, result, proj, score_threshold=0.3)
    want = jax_vis.render_frame(imgs, result, proj, score_threshold=0.3)
    assert got.dtype == want.dtype and got.shape == (64, 256, 3)
    np.testing.assert_array_equal(got, want)
    blank = visualize.render_frame(imgs, dict(result, scores_3d=result[
        "scores_3d"] * 0), proj)
    assert (blank != got).any()
    np.testing.assert_array_equal(visualize.box3d_corners(result[
        "boxes_3d"]), jax_vis.box3d_corners(result["boxes_3d"]))


def test_render_needs_cv2(monkeypatch):
    import sys

    imgs, result, proj = _frame_inputs()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        visualize.render_frame(imgs, result, proj)


def test_show_dir_renders_the_stream(infos, tmp_path, monkeypatch):
    """`streaming_eval(show_dir=...)` on the tiny config: every frame is
    rendered from its decode, pixel for pixel as JAX's `render_frame`
    draws the same decode, and the video is written."""
    from simpb_tpu_torch.tools import test as test_cli
    from simpb_tpu_torch.training import evaluate

    cfg = simpb_tiny()
    ds = NuScenesDataset(infos, test_mode=True, sequences_split_num=1,
                         data_aug_conf=test_cli.eval_aug_conf(cfg, SRC_H,
                                                              SRC_W))
    model = evaluate.build_model(cfg, device="cpu", seed=0)
    drawn = []
    real = visualize.render_frame
    monkeypatch.setattr(visualize, "render_frame", lambda *a, **k: (
        drawn.append((a, k, real(*a, **k))) or drawn[-1][2]))
    show = tmp_path / "vis"
    evaluate.streaming_eval(model, cfg, ds, max_frames=3, show_dir=str(show),
                            show_threshold=0.0)
    assert len(drawn) == 3
    for args, kw, frame in drawn:
        np.testing.assert_array_equal(frame, jax_vis.render_frame(*args,
                                                                  **kw))
    assert (show / "detections.mp4").stat().st_size > 0
