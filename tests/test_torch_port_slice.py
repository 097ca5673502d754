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
            jo = cold.lower(*args).compile(opts)(*args)
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
    return jcfg, jouts, touts, variables


def _close(t, j, msg):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=ATOL, rtol=RTOL, err_msg=msg)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_head_outputs_match(slice_run, frame):
    _, jouts, touts, _ = slice_run
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
    cfg, jouts, touts, _ = slice_run
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

    variables = slice_run[3]
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
    """The port and chip_smoke.py import neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import simpb_tpu_torch
        for m in pkgutil.walk_packages(simpb_tpu_torch.__path__,
                                       "simpb_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "simpb_tpu")]
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
