"""The port's serving slice against the JAX package, end to end.

`simpb_tiny` with the flagship fast knobs (windowed MSDA with top-2
level selection and slot capacity, DFA gather capacity) and
`backbone_fused_infer=True`: one cold frame and two stream frames
through `simpb_tpu_torch` (fused trunk, its kernels' plain versions on
the CPU) and through the JAX `SimPB` (module trunk: interpreting 16
Pallas blocks is too slow here, and tests/test_conv_fused.py ties the
two JAX trunks together at 2e-5).

Weights: the JAX variable tree's shapes come from `jax.eval_shape`, its
values from a numpy seed; `from_jax_variables` converts them and the
port loads them with strict=True. Tolerance: atol 5e-4 / rtol 1e-3,
the bound of tests/test_torch_composite.py for the assembled head
(fp32 reassociation through six decoder layers and the trunk).
"""
import collections
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs.base import simpb_tiny as jax_tiny
from simpb_tpu.models.decoder3d import decode_boxes3d as jax_decode
from simpb_tpu.models.detector import SimPB as JaxSimPB
from simpb_tpu.utils.synthetic import synthetic_anchors, synthetic_rig
from simpb_tpu_torch.configs.base import simpb_tiny
from simpb_tpu_torch.models.decoder3d import decode_boxes3d
from simpb_tpu_torch.models.detector import SimPB
from simpb_tpu_torch.models.instance_bank import TemporalState
from simpb_tpu_torch.utils.convert import from_jax_variables

ATOL, RTOL = 5e-4, 1e-3
BS, CAMS, IMG_W, IMG_H = 1, 6, 64, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fast(cfg, fused):
    head = dataclasses.replace(
        cfg.head, msda_patch_mode=True, msda_gather_capacity=6,
        dfa_gather_capacity=256, msda_sel_levels=2,
    )
    return dataclasses.replace(cfg, head=head, backbone_fused_infer=fused)


def random_jax_variables(shapes, seed=0):
    """Fill a JAX variable tree (of ShapeDtypeStructs) with seeded numpy
    values at scales that keep activations in range."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
            if keys[-2] == "out_fc":
                # refinement deltas stay small, as in a trained model:
                # with full-size random deltas the decoder is chaotic (a
                # 1e-7 relative change of its input features moved the
                # last layer's boxes by 1e-3)
                v = 0.1 * v
        elif name == "anchor":
            v = synthetic_anchors(shape[0], seed)
        elif name == "instance_feature":
            v = np.zeros(shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "mean":
            v = 0.1 * rng.normal(size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias
            v = 0.05 * rng.normal(size=shape)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _temp2cur(theta, tx, ty):
    t = np.eye(4, dtype=np.float32)
    c, s = np.cos(theta), np.sin(theta)
    t[:2, :2] = [[c, -s], [s, c]]
    t[:2, 3] = [tx, ty]
    return t[None]


# the fixture's configs, outputs, JAX variables, compiled JAX steps
# (cold, stream) and the port's model
SliceRun = collections.namedtuple(
    "SliceRun", "jcfg tcfg jouts touts variables jax_steps tmodel")


@pytest.fixture(scope="module")
def slice_run():
    torch.set_num_threads(1)
    jcfg = _fast(jax_tiny(), fused=False)
    tcfg = _fast(simpb_tiny(), fused=True)
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(3, BS, CAMS, IMG_H, IMG_W, 3)).astype(np.float32)
    proj = synthetic_rig(BS, (IMG_W, IMG_H))
    dts = [np.full((BS,), 0.5, np.float32), np.full((BS,), 0.4, np.float32)]
    t2cs = [_temp2cur(0.05, 0.8, -0.3), _temp2cur(-0.02, 0.5, 0.1)]

    jmodel = JaxSimPB(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(imgs[0]),
                            jnp.asarray(proj), train=False)
    )
    variables = random_jax_variables(shapes)
    state_dict = from_jax_variables(variables, tcfg)
    tmodel = SimPB(tcfg)
    tmodel.load_state_dict(state_dict, strict=True)
    tmodel.eval()

    # jitted: two compilations cost less than three eager frames here.
    # Compiling them is most of this file's time; XLA's backend at
    # optimisation level 1 compiles them about a quarter faster than the
    # default level 2, and runs them as fast.
    opts = {"xla_backend_optimization_level": 1}
    cold = jax.jit(lambda v, img, p: jmodel.apply(v, img, p, train=False))
    stream = jax.jit(lambda v, img, p, s, dt, t2c: jmodel.apply(
        v, img, p, temporal=s, time_interval=dt, temp2cur=t2c, train=False))
    jouts, touts = [], []
    jstate = None
    for f in range(3):
        if f:
            args = (variables, jnp.asarray(imgs[f]), jnp.asarray(proj),
                    jstate, jnp.asarray(dts[f - 1]),
                    jnp.asarray(t2cs[f - 1]))
            if f == 1:
                stream = stream.lower(*args).compile(opts)
            jo = stream(*args)
        else:
            args = (variables, jnp.asarray(imgs[f]), jnp.asarray(proj))
            cold = cold.lower(*args).compile(opts)
            jo = cold(*args)
        jo = jax.tree_util.tree_map(np.asarray, jo)
        # both packages take the SAME incoming state each frame, so a
        # near-tie in the bank's top-k can not make later frames diverge
        tkw = {}
        if f:
            tkw = dict(
                temporal=TemporalState(**{
                    k: torch.from_numpy(np.array(getattr(jstate, k)))
                    for k in ("feature", "anchor", "confidence",
                              "instance_id", "prev_id")
                }),
                time_interval=torch.from_numpy(dts[f - 1]),
                temp2cur=torch.from_numpy(t2cs[f - 1]),
            )
        to = tmodel(torch.from_numpy(imgs[f]), torch.from_numpy(proj), **tkw)
        jouts.append(jo)
        touts.append(to)
        jstate = jo["temporal_state"]
    return SliceRun(jcfg, tcfg, jouts, touts, variables, (cold, stream),
                    tmodel)


def _close(t, j, msg):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=ATOL, rtol=RTOL, err_msg=msg)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_head_outputs_match(slice_run, frame):
    jouts, touts = slice_run.jouts, slice_run.touts
    jo, to = jouts[frame], touts[frame]
    for key in ("prediction", "classification", "quality", "prediction2d",
                "classification2d", "prediction_alpha2d"):
        assert len(jo[key]) == len(to[key]), key
        for lyr, (j, t) in enumerate(zip(jo[key], to[key])):
            assert (j is None) == (t is None), f"{key} {lyr}"
            if t is not None:
                _close(t, j, f"frame {frame} {key} layer {lyr}")
    for a_j, a_t in zip(jo["allocations"], to["allocations"]):
        np.testing.assert_array_equal(a_t.parent_idx.numpy(),
                                      np.asarray(a_j.parent_idx))
        np.testing.assert_array_equal(a_t.valid.numpy(),
                                      np.asarray(a_j.valid))


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_decode_and_instance_ids_match(slice_run, frame):
    cfg, jouts, touts = slice_run.jcfg, slice_run.jouts, slice_run.touts
    jo, to = jouts[frame], touts[frame]
    np.testing.assert_array_equal(to["instance_id"].numpy(),
                                  np.asarray(jo["instance_id"]))
    kw = dict(num_output=cfg.head.num_output,
              score_threshold=cfg.head.score_threshold)
    jd = jax_decode(
        jnp.asarray(jo["classification"][-1]),
        jnp.asarray(jo["prediction"][-1]),
        instance_id=jnp.asarray(jo["instance_id"]),
        quality=jnp.asarray(jo["quality"][-1]), **kw,
    )
    td = decode_boxes3d(
        to["classification"][-1], to["prediction"][-1],
        instance_id=to["instance_id"], quality=to["quality"][-1], **kw,
    )
    for key in ("anchor_idx", "labels_3d", "valid", "instance_ids"):
        np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    for key in ("boxes_3d", "scores_3d", "cls_scores"):
        _close(td[key], jd[key], f"frame {frame} {key}")
    # the carried state: ids exactly, cached values to tolerance
    js, ts = jo["temporal_state"], to["temporal_state"]
    np.testing.assert_array_equal(ts.instance_id.numpy(),
                                  np.asarray(js.instance_id))
    np.testing.assert_array_equal(ts.prev_id.numpy(), np.asarray(js.prev_id))
    for key in ("feature", "anchor", "confidence"):
        _close(getattr(ts, key), getattr(js, key), f"state {key}")


def test_from_jax_variables_strict(slice_run):
    """The converted tree loads with strict=True and lands in the right
    layout. A tree initialised for training also carries the depth
    branch and the intermediate refine3d cls/quality branches: the
    converter drops those, and refuses any other stray leaf."""
    import copy

    variables = slice_run.variables
    tcfg = _fast(simpb_tiny(), fused=True)
    train_tree = copy.deepcopy(variables)
    k = np.ones((1, 1, 64, 1), np.float32)
    train_tree["params"]["depth_branch"] = {
        "depth_layer_0": {"kernel": k, "bias": np.zeros(1, np.float32)}
    }
    train_tree["params"]["head"]["op15_refine3d"]["cls_fc"] = {
        "kernel": np.ones((64, 10), np.float32)
    }
    model = SimPB(tcfg)
    res = model.load_state_dict(from_jax_variables(train_tree, tcfg),
                                strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    w = variables["params"]["head"]["op12_deformable"]["weights_fc"]["kernel"]
    np.testing.assert_array_equal(
        model.head.op12_deformable.weights_fc.weight.detach().numpy(), w.T
    )
    conv = variables["params"]["img_backbone"]["layer2_0"]["conv2"]["kernel"]
    np.testing.assert_array_equal(
        model.img_backbone.layer2_0.conv2.weight.detach().numpy(),
        conv.transpose(3, 2, 0, 1),
    )
    train_tree["params"]["stray"] = {"kernel": w}
    with pytest.raises(KeyError, match="no counterpart"):
        from_jax_variables(train_tree, tcfg)


def test_port_imports_no_jax():
    """The port (every module `walk_packages` finds, the probe tool, the
    CLIs, the checkpoint, watchdog, export, BN-folding, dataset-wrapper,
    rendering and encoder modules among them) and chip_smoke.py import
    neither JAX nor the JAX package, and none imports PIL or OpenCV at
    module level (the card's machine has neither)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import simpb_tpu_torch
        for m in pkgutil.walk_packages(simpb_tpu_torch.__path__,
                                       "simpb_tpu_torch."):
            importlib.import_module(m.name)
        for name in ("tools.mosaic_probe", "tools.test", "tools.train",
                     "tools.profile", "tools.benchmark", "tools.export",
                     "tools.fuse_conv_bn", "training.checkpoint",
                     "utils.watchdog", "utils.export", "utils.fuse_bn",
                     "data.wrappers", "data.visualize", "models.encoder2d",
                     "bench"):
            assert "simpb_tpu_torch." + name in sys.modules, name
        import chip_smoke
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "simpb_tpu",
                                      "orbax", "PIL", "cv2")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_point_without_device_raises(monkeypatch):
    """No card and no device= -> the entry point raises, never falls
    back to the CPU on its own."""
    from simpb_tpu_torch.training.evaluate import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(_fast(simpb_tiny(), fused=True))
    model = build_model(_fast(simpb_tiny(), fused=True), device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_streaming_eval_matches_jax(slice_run, tmp_path, monkeypatch):
    """The whole evaluation path: the JAX `streaming_eval` and the port's
    over one fake nuScenes-format set (PNG images, two scenes, four
    frames, the fixture's 64x32 input), scoring detection and tracking.
    The JAX side runs the fixture's compiled steps, through
    `_jitted_steps` pointed at them, so nothing compiles again. Each
    frame's decode: valid mask, labels and instance ids equal, boxes
    and scores within the slice tolerance; then the global-frame
    predictions, and every metric within 1e-3."""
    import simpb_tpu.training.evaluate as jeval
    from simpb_tpu.data.dataset import NuScenesDataset as JaxDataset
    from simpb_tpu_torch.data.dataset import NuScenesDataset
    from simpb_tpu_torch.tools.test import eval_aug_conf
    from simpb_tpu_torch.training import evaluate as teval
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    run = slice_run
    cold_c, stream_c = run.jax_steps
    kw = dict(num_output=run.jcfg.head.num_output,
              score_threshold=run.jcfg.head.score_threshold)
    jdecs, tdecs = [], []

    def decoded(out):
        dec = jax_decode(out["classification"][-1], out["prediction"][-1],
                         instance_id=out["instance_id"],
                         quality=out["quality"][-1], **kw)
        jdecs.append({k: np.asarray(v)[0] for k, v in dec.items()})
        return dec, out["temporal_state"]

    def steps(model, cfg, cam_mesh=None):
        return (lambda v, img, p: decoded(cold_c(v, img, p)),
                lambda v, img, p, s, dt, t2c: decoded(
                    stream_c(v, img, p, s, dt, t2c)))

    to_host = teval._decode_to_host

    def recorded(dec):
        tdecs.append(to_host(dec))
        return tdecs[-1]

    monkeypatch.setattr(jeval, "_jitted_steps", steps)
    monkeypatch.setattr(teval, "_decode_to_host", recorded)
    pkl = write_synthetic_infos(str(tmp_path), n_frames=4, gap_at=(2,),
                                src_hw=(60, 100), num_objects=8,
                                write_images=True)
    dkw = dict(test_mode=True, sequences_split_num=1,
               data_aug_conf=eval_aug_conf(run.tcfg, 60, 100))
    jm, jp, jt = jeval.streaming_eval(None, run.jcfg, run.variables,
                                      JaxDataset(pkl, **dkw), tracking=True)
    tm, tp, tt = teval.streaming_eval(run.tmodel, run.tcfg,
                                      NuScenesDataset(pkl, **dkw),
                                      tracking=True)
    assert tt == jt == [f"tok{i}" for i in range(4)]
    assert len(jdecs) == len(tdecs) == 4
    for f, (j, t) in enumerate(zip(jdecs, tdecs)):
        for key in ("valid", "labels_3d", "instance_ids", "anchor_idx"):
            np.testing.assert_array_equal(t[key], j[key],
                                          err_msg=f"frame {f} {key}")
        for key in ("boxes_3d", "scores_3d"):
            np.testing.assert_allclose(t[key], j[key], atol=ATOL, rtol=RTOL,
                                       err_msg=f"frame {f} {key}")
    for f, (j, t) in enumerate(zip(jp, tp)):
        assert sorted(t) == sorted(j)
        for key in ("labels", "track_ids", "ego_xy"):
            np.testing.assert_array_equal(t[key], j[key])
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(t[key], j[key], atol=ATOL, rtol=RTOL,
                                       err_msg=f"frame {f} {key}")
    assert list(tm) == list(jm)
    assert {"mAP", "NDS", "AMOTA", "AMOTP"} <= set(tm)
    np.testing.assert_allclose([tm[k] for k in tm], [jm[k] for k in jm],
                               atol=1e-3, rtol=0)


def test_load_torch_checkpoint_matches_from_jax(slice_run, tmp_path):
    """A reference-named `.pth` made from the fixture's JAX variables by
    the JAX package's `flax_to_torch` loads through the port's
    `load_torch_checkpoint` into exactly the tensors that
    `from_jax_variables` gives for the same variables, every key; keys
    the file lacks keep the model's own values, and another layout is
    refused."""
    from simpb_tpu.utils.torch_convert import flax_to_torch
    from simpb_tpu_torch.utils.torch_convert import load_torch_checkpoint

    run = slice_run
    sd = flax_to_torch(run.variables["params"], run.variables["batch_stats"],
                       run.jcfg)
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, pth)
    want = from_jax_variables(run.variables, run.tcfg)
    base = SimPB(run.tcfg)
    got = load_torch_checkpoint(str(pth), run.tcfg, base)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    # a file without the head keeps the model's own head values
    own = base.state_dict()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()
                if not k.startswith("head.")}, pth)
    got = load_torch_checkpoint(str(pth), run.tcfg, base)
    for k in want:
        src = own if k.startswith("head.") else want
        assert torch.equal(got[k], src[k]), k

    conv = "img_backbone.layer1.0.conv2.weight"
    torch.save({conv: torch.from_numpy(np.array(sd[conv])).permute(
        2, 3, 1, 0).contiguous()}, pth)  # the JAX layout, not torch's
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torch_checkpoint(str(pth), run.tcfg, base)
    torch.save({"fc.weight": torch.ones(3, 3)}, pth)
    with pytest.raises(ValueError, match="no SimPB parameters"):
        load_torch_checkpoint(str(pth), run.tcfg, base)


def _jax_steps_recording(run, jdecs):
    """`_jitted_steps` of the JAX eval pointed at the fixture's compiled
    steps, each decode recorded in `jdecs` (first sample)."""
    cold_c, stream_c = run.jax_steps
    kw = dict(num_output=run.jcfg.head.num_output,
              score_threshold=run.jcfg.head.score_threshold)

    def decoded(out):
        dec = jax_decode(out["classification"][-1], out["prediction"][-1],
                         instance_id=out["instance_id"],
                         quality=out["quality"][-1], **kw)
        jdecs.append({k: np.asarray(v)[0] for k, v in dec.items()})
        return dec, out["temporal_state"]

    def steps(model, cfg, cam_mesh=None):
        return (lambda v, img, p: decoded(cold_c(v, img, p)),
                lambda v, img, p, s, dt, t2c: decoded(
                    stream_c(v, img, p, s, dt, t2c)))

    return steps


def _same_predictions(tp, jp):
    assert len(tp) == len(jp)
    for f, (j, t) in enumerate(zip(jp, tp)):
        assert sorted(t) == sorted(j)
        for key in ("labels", "track_ids", "ego_xy"):
            np.testing.assert_array_equal(t[key], j[key])
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(t[key], j[key], atol=ATOL, rtol=RTOL,
                                       err_msg=f"frame {f} {key}")


def _eval_set(run, directory):
    from simpb_tpu.data.dataset import NuScenesDataset as JaxDataset
    from simpb_tpu_torch.data.dataset import NuScenesDataset
    from simpb_tpu_torch.tools.test import eval_aug_conf
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    pkl = write_synthetic_infos(str(directory), n_frames=4, gap_at=(2,),
                                src_hw=(60, 100), num_objects=8,
                                write_images=True)
    dkw = dict(test_mode=True, sequences_split_num=1,
               data_aug_conf=eval_aug_conf(run.tcfg, 60, 100))
    return JaxDataset(pkl, **dkw), NuScenesDataset(pkl, **dkw)


def test_distributed_streaming_eval_matches_jax(slice_run, tmp_path,
                                                monkeypatch):
    """The disk-gather eval driven as ranks 1 then 0 of two in one
    process, in both packages, over one fake set of two scenes (one
    shard a rank), the JAX side on the fixture's compiled steps: the
    same frames in the same order, each decode (valid mask, labels,
    instance ids equal; boxes and scores within the slice tolerance),
    the merged predictions, and every metric within 1e-3."""
    import simpb_tpu.training.evaluate as jeval
    from simpb_tpu_torch.training import evaluate as teval

    run = slice_run
    jdecs, tdecs = [], []
    monkeypatch.setattr(jeval, "_jitted_steps",
                        _jax_steps_recording(run, jdecs))
    to_host = teval._decode_to_host
    monkeypatch.setattr(teval, "_decode_to_host",
                        lambda dec: tdecs.append(to_host(dec)) or tdecs[-1])
    jds, tds = _eval_set(run, tmp_path / "set")
    for r in (1, 0):
        j = jeval.distributed_streaming_eval(
            None, run.jcfg, run.variables, jds, str(tmp_path / "jax"),
            world_size=2, rank=r, tracking=True)
        t = teval.distributed_streaming_eval(
            run.tmodel, run.tcfg, tds, str(tmp_path / "port"), world_size=2,
            rank=r, tracking=True)
        assert (j is None) == (t is None) == (r == 1)
    (jm, jp, jt), (tm, tp, tt) = j, t
    # rank 1's shard streamed first, then rank 0's
    assert tt == jt == [f"tok{i}" for i in range(4)]
    assert len(jdecs) == len(tdecs) == 4
    for f, (jd, td) in enumerate(zip(jdecs, tdecs)):
        for key in ("valid", "labels_3d", "instance_ids", "anchor_idx"):
            np.testing.assert_array_equal(td[key], jd[key],
                                          err_msg=f"frame {f} {key}")
        for key in ("boxes_3d", "scores_3d"):
            np.testing.assert_allclose(td[key], jd[key], atol=ATOL,
                                       rtol=RTOL, err_msg=f"frame {f} {key}")
    _same_predictions(tp, jp)
    assert list(tm) == list(jm)
    assert {"mAP", "NDS", "AMOTA", "AMOTP"} <= set(tm)
    np.testing.assert_allclose([tm[k] for k in tm], [jm[k] for k in jm],
                               atol=1e-3, rtol=0)


def test_multidevice_streaming_eval_matches_bs1_streams(slice_run, tmp_path):
    """`multidevice_streaming_eval(devices=["cpu"] * 2)`: the two scenes'
    shards as the two slots of a bs-2 batch, each frame's prediction
    that of streaming its shard alone at bs 1 (`streaming_eval` with
    world_size 2 and its rank), shard-major, the same metrics; with
    three slots and two scenes the slots shrink to two (the same
    result), and `max_frames` is the total, split over the shards."""
    from simpb_tpu_torch.training import evaluate as teval

    run = slice_run
    _, tds = _eval_set(run, tmp_path / "set")
    multi = teval.multidevice_streaming_eval(
        run.tmodel, run.tcfg, tds, devices=["cpu"] * 2, tracking=True)
    singles = [teval.streaming_eval(run.tmodel, run.tcfg, tds, world_size=2,
                                    rank=r, tracking=True) for r in (0, 1)]
    assert multi[2] == singles[0][2] + singles[1][2] == [
        f"tok{i}" for i in range(4)]
    _same_predictions(multi[1], singles[0][1] + singles[1][1])
    assert {"mAP", "NDS", "AMOTA", "AMOTP"} <= set(multi[0])
    shrunk = teval.multidevice_streaming_eval(
        run.tmodel, run.tcfg, tds, devices=["cpu"] * 3, tracking=True)
    assert shrunk[2] == multi[2]
    _same_predictions(shrunk[1], multi[1])
    capped = teval.multidevice_streaming_eval(
        run.tmodel, run.tcfg, tds, devices=["cpu"] * 2, max_frames=2)
    assert capped[2] == ["tok0", "tok2"]
