"""The port's whole tiny training step against the JAX package's (slow:
minutes of JAX compile, outside tier-1; run it with `-m slow`).

`simpb_tiny` with the flagship's fast knobs (windowed MSDA) or with its
own exact MSDA, dropout rates 0 and no grid mask, so that the step is
deterministic on both sides: JAX's head gets
no "sampling" rng (allocation ranks in anchor order and `cache_dn` is
skipped), and `flax.linen.Dropout` is made the identity for the test
(the 2D self-attention's output dropout is 0.1 whatever the config says;
the port runs it without a dropout generator, which is the identity
too). The DN bundle comes from the same uniforms on both sides
(`jax.random.split(key, 3)`, as `get_dn_anchors` draws them). Weights:
a JAX training tree from a numpy seed, converted by
`from_jax_variables(..., train=True)` and loaded with strict=True.

Each test runs for both MSDA modes, each twice: on a batch of
`synthetic_train_batch`, and on a batch of the training CLI's data
pipeline (`tools/train.py::make_batch`
over a fake nuScenes-format pkl: augmented images, 2D GT from projected
boxes, LiDAR depth maps, a stream frame's dt and temp2cur). On the
pipeline batch the trunk (and depth branch) runs in float64 on both
sides: its images carry each camera's brightness and contrast jitter,
and with random weights the trunk's one-pass batch variance
(E[x^2] - E[x]^2, flax's, which the port computes the same way) then
cancels in fp32 at depth 26 too, so that fp32 gradients move by up to
7 % of their largest value when the BatchNorm's scale and shift alone
are evaluated in float64 (the port, layer3's downsample; 1e-5 on the
synthetic batch). The head runs in fp32 on JAX's trunk outputs rounded
to fp32, as on the synthetic batch.

The step is compared in its three parts, each on the same inputs: the
trunk (with the depth branch) on the batch; the head and the loss on
JAX's trunk outputs; the trunk's backward from JAX's gradients of those
outputs. Together they are the whole step's loss and gradient; apart,
neither package's rounding of the trunk reaches the other's head. The
trunk is cut to depth 26 (one bottleneck a stage; the head is the tiny
config's): at depth 50 and 64x32, a training step with random weights is
ill-conditioned in fp32 (in the port alone, a 1e-6 relative change of
the trunk's weights moves its outputs by 1.9e-4 and the gradients by up
to 5.6 %, and a ReLU input within a rounding of zero flips between two
fp32 evaluations; tests/test_torch_port_train_trunk.py).

Compared: the trunk's outputs (1e-4 of the largest value: C5's batch
statistics come from 12 values a channel), the loss dict (same keys,
1e-4 relative), each layer's 3D and 2D assignment (the class targets
exactly; a flip is reported with the labels), the gradient the head
sends into the trunk and the gradient of every parameter (5e-4 of its
largest value, the head's bound, plus 1e-6 for gradients that vanish in
exact arithmetic, such as a key bias, which moves every logit of a row
alike: both sides hold rounding noise of 1e-7 there; the frozen
`instance_feature` is left out: JAX computes its gradient and its
optimizer zeroes the update, the port's parameter takes none), the new
`batch_stats` (1e-5) and the carried temporal state (atol 5e-4, rtol
1e-3, as tests/test_torch_port_slice.py holds the assembled head).
"""
import contextlib
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs.base import TrainConfig as JTrainConfig
from simpb_tpu.configs.base import simpb_tiny as jax_tiny
from simpb_tpu.models.detector import SimPB as JaxSimPB
from simpb_tpu.ops import format as jfmt
from simpb_tpu.training import loss_head as jlh
from simpb_tpu.training import targets2d as jt2
from simpb_tpu.training import targets3d as jt3
from simpb_tpu.training.train_step import init_temporal as jinit_temporal
from simpb_tpu.utils.synthetic import synthetic_anchors
from simpb_tpu_torch.configs.base import TrainConfig, simpb_tiny
from simpb_tpu_torch.models.detector import SimPB
from simpb_tpu_torch.training import loss_head as tlh
from simpb_tpu_torch.training import targets2d as tt2
from simpb_tpu_torch.training import targets3d as tt3
from simpb_tpu_torch.training.train_step import init_temporal
from simpb_tpu_torch.utils.convert import _sources, from_jax_variables
from simpb_tpu_torch.utils.synthetic import (
    batch_to_torch, synthetic_train_batch,
)

pytestmark = pytest.mark.slow
BS = 1
TRUNK_TOL = 1e-4  # see the module docstring
GRAD_TOL, GRAD_FLOOR = 5e-4, 1e-6


def _parity(cfg, msda):
    """The parity config: `msda` "windowed" takes the flagship's fast
    knobs, "exact" keeps the tiny config's exact MSDA."""
    fast = dict(msda_patch_mode=True, msda_gather_capacity=6,
                dfa_gather_capacity=256, msda_sel_levels=2)
    head = dataclasses.replace(
        cfg.head, drop_out=0.0, dfa_attn_drop=0.0,
        **(fast if msda == "windowed" else {}))
    return dataclasses.replace(cfg, head=head, use_grid_mask=False,
                               backbone_depth=26)


def _random_tree(shapes, seed=0):
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
            if keys[-2] == "out_fc":
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
        else:
            v = 0.05 * rng.normal(size=shape)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _targets(sample3d, sample2d, outs, batch, image_wh):
    t3 = [sample3d(c, p[..., :10], batch["gt_boxes3d"], batch["gt_labels3d"],
                   batch["gt_valid3d"])[0]
          for c, p in zip(outs["classification"], outs["prediction"])]
    t2 = [sample2d(c, p, a.valid, batch["gt_boxes2d"], batch["gt_labels2d"],
                   batch["gt_alphas2d"], batch["gt_valid2d"], image_wh)[0]
          for c, p, a in zip(outs["classification2d"], outs["prediction2d"],
                             outs["allocations"])]
    return t3, t2


def _pipeline_batch(tcfg, directory):
    """The second batch of the training CLI's data stream (`make_batch`
    over a fake nuScenes-format pkl with PNG images, 2D GT and LiDAR
    files): a stream frame, dt 0.5 s, with its temp2cur."""
    from simpb_tpu_torch.data.dataset import NuScenesDataset
    from simpb_tpu_torch.data.sampler import GroupStreamSampler
    from simpb_tpu_torch.tools import train as train_cli
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    pkl = write_synthetic_infos(str(directory), n_frames=6, gap_at=(),
                                src_hw=(80, 160), num_objects=8,
                                write_images=True, with_2d=True,
                                with_lidar=True)
    ds = NuScenesDataset(
        pkl, test_mode=False, sequences_split_num=1,
        data_aug_conf=train_cli.train_aug_conf(tcfg, 80, 160),
        strides=tcfg.strides[: tcfg.num_depth_layers])
    it = iter(GroupStreamSampler(ds, BS, seed=0, skip_prob=0.0,
                                 sequence_flip_prob=0.0))
    rng, pose = np.random.default_rng(0), [None] * BS
    train_cli.make_batch(ds, next(it), rng, pose, tcfg)
    batch = train_cli.make_batch(ds, next(it), rng, pose, tcfg)
    assert float(batch["time_interval"][0]) == 0.5
    return batch


TRUNK_MODULES = ("img_backbone", "img_neck", "depth_branch")


def _rows(outs):
    """Each 3D and 2D layer's (classification, prediction) outputs, the
    rows an assignment is made from."""
    return ([(c, p) for c, p in zip(outs["classification"],
                                   outs["prediction"])],
            [(c, p) for c, p in zip(outs["classification2d"],
                                   outs["prediction2d"])])


@pytest.fixture(scope="module", params=[
    (batch, msda) for msda in ("windowed", "exact")
    for batch in ("synthetic", "pipeline")], ids="-".join)
def step_run(request, tmp_path_factory):
    """The step's pieces on a batch of `synthetic_train_batch`, or on one
    of the training CLI's data pipeline (`make_batch`), whose trunk runs
    in float64 on both sides (see the module docstring), with windowed or
    exact MSDA."""
    torch.set_num_threads(1)
    kind, msda = request.param
    jcfg, tcfg = _parity(jax_tiny(), msda), _parity(simpb_tiny(), msda)
    f64 = kind == "pipeline"
    if f64:
        batch_np = _pipeline_batch(tcfg, tmp_path_factory.mktemp("pipe"))
    else:
        batch_np = synthetic_train_batch(tcfg, BS, seed=4, num_objects=8,
                                         max_gt3d=8, max_gt2d=6)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch_np)
    model = JaxSimPB(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jbatch["img"], jbatch["projection_mat"], train=True))
    variables = _random_tree(shapes)
    key_dn = jax.random.PRNGKey(11)
    temporal, dn_state = jinit_temporal(jcfg, BS)
    h = jcfg.head
    wh = jcfg.input_size
    ss = jfmt.SpatialShapes(jcfg.feature_shapes)
    # the trunk's dtype, variables and image: float64 for the pipeline
    # batch, with JAX's 64-bit mode on and its SimPB's compute dtype (a
    # property that knows bf16 and fp32 only) made float64 for the
    # trunk's calls; the depth branch computes in fp32 whatever the
    # trunk's dtype, in both packages
    tdtype = np.float64 if f64 else np.float32
    trunk_vars = jax.tree_util.tree_map(lambda a: a.astype(tdtype),
                                        variables)

    @contextlib.contextmanager
    def x64():
        if not f64:
            yield
            return
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp64:
            mp64.setattr(JaxSimPB, "dtype", property(lambda _: jnp.float64))
            yield

    # the trunk (and depth branch) as a function of the parameters
    def trunk(params):
        (col, _, depths), mut = model.apply(
            {"params": params, "batch_stats": trunk_vars["batch_stats"]},
            jnp.asarray(batch_np["img"], tdtype), train=True,
            focal=jbatch["focal"], return_depth=True,
            method=JaxSimPB.extract_feat, mutable=["batch_stats"])
        return (col, depths), mut["batch_stats"]

    # the head and the loss as a function of the parameters and of the
    # trunk's outputs
    def head_loss(params, col, depths):
        dn = jt3.get_dn_anchors(
            key_dn, jbatch["gt_boxes3d"], jbatch["gt_labels3d"],
            jbatch["gt_valid3d"], gt_instance_id=jbatch["gt_instance_id"],
            gt_vis2d=jbatch["gt_vis2d_per3d"],
            gt_boxes2d=jbatch["gt_boxes2d_per3d"],
            gt_labels2d=jbatch["gt_labels2d_per3d"],
            gt_alphas2d=jbatch["gt_alphas2d_per3d"],
            num_dn_groups=h.num_dn_groups, max_dn_gt=h.max_dn_gt,
            add_neg_dn=h.add_neg_dn, noise_scale=h.dn_noise_scale,
            num_cams=h.num_cams)
        outs = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            col, ss, jbatch["projection_mat"], wh, temporal=temporal,
            time_interval=jbatch["time_interval"],
            temp2cur=jbatch["temp2cur"], dn=dn, dn_state=dn_state,
            train=True, rngs={"dropout": jax.random.PRNGKey(6)},
            method=lambda m, *a, **k: m.head(*a, **k))
        outs["depth_preds"] = depths
        loss, ld = jlh.total_loss(outs, jbatch, JTrainConfig(), image_wh=wh)
        tgt = _targets(jt3.sample_targets3d,
                       lambda *a: jt2.sample_targets2d(*a[:7], image_wh=a[7]),
                       outs, jbatch, wh)
        return loss, (ld, outs["temporal_state"], tgt, _rows(outs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        with x64():
            (jcol, jdepths), jstats = jax.jit(
                lambda p: trunk(p))(trunk_vars["params"])
            jcol = np.asarray(jcol)
            jstats = jax.tree_util.tree_map(np.asarray, jstats)
        (jloss, (jld, jtemp, jtgt, jrows)), (jg_head, jg_col, jg_depths) = \
            jax.jit(jax.value_and_grad(head_loss, argnums=(0, 1, 2),
                                       has_aux=True))(
                variables["params"], jcol.astype(np.float32), jdepths)
        with x64():
            jg_trunk = jax.jit(lambda p, gc, gd: jax.vjp(
                lambda q: trunk(q)[0], p)[1]((gc, gd))[0])(
                    trunk_vars["params"], np.asarray(jg_col, tdtype),
                    jg_depths)
            jg_trunk = jax.tree_util.tree_map(np.asarray, jg_trunk)

    # the port: the same three pieces, the head on JAX's trunk outputs and
    # the trunk's backward from JAX's output gradients
    sd = from_jax_variables(variables, tcfg, train=True)
    tmodel = SimPB(tcfg, train=True)
    tmodel.load_state_dict(sd, strict=True)
    ttrunk = tmodel
    if f64:
        ttrunk = SimPB(tcfg, train=True)
        ttrunk.load_state_dict(sd, strict=True)
        ttrunk.double().compute_dtype = torch.float64
    tb = batch_to_torch(batch_np, "cpu")
    col, tss, depths = ttrunk.extract_feat_train(
        tb["img"].to(ttrunk.compute_dtype), tb["focal"])
    g, per = h.num_dn_groups * BS, h.max_dn_gt
    k1, k2, k3 = jax.random.split(key_dn, 3)
    draws = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (g, per,
                                                                   10))))
                  for k in (k1, k2, k3))
    dn = tt3.get_dn_anchors(
        draws, tb["gt_boxes3d"], tb["gt_labels3d"], tb["gt_valid3d"],
        gt_instance_id=tb["gt_instance_id"], gt_vis2d=tb["gt_vis2d_per3d"],
        gt_boxes2d=tb["gt_boxes2d_per3d"], gt_labels2d=tb["gt_labels2d_per3d"],
        gt_alphas2d=tb["gt_alphas2d_per3d"], num_dn_groups=h.num_dn_groups,
        max_dn_gt=h.max_dn_gt, add_neg_dn=h.add_neg_dn,
        noise_scale=h.dn_noise_scale, num_cams=h.num_cams)
    ttemp, tdn_state = init_temporal(tcfg, BS, "cpu")
    hcol = torch.from_numpy(jcol.astype(np.float32)).requires_grad_(True)
    hdepths = [torch.from_numpy(np.array(d)).requires_grad_(True)
               for d in jdepths]
    outs = tmodel.head(hcol, tss, tb["projection_mat"], wh, temporal=ttemp,
                       time_interval=tb["time_interval"],
                       temp2cur=tb["temp2cur"], dn=dn, dn_state=tdn_state,
                       train=True)
    outs["depth_preds"] = hdepths
    loss, ld = tlh.total_loss(outs, tb, TrainConfig(), image_wh=wh)
    loss.backward()
    torch.autograd.backward(
        [col] + list(depths),
        [torch.from_numpy(np.asarray(jg_col, tdtype))]
        + [torch.from_numpy(np.array(d)) for d in jg_depths])
    with torch.no_grad():
        ttgt = _targets(tt3.sample_targets3d, tt2.sample_targets2d, outs, tb,
                        wh)
    # a parameter's gradient: the trunk's from its backward, the rest from
    # the head's (each zero in the other)
    jgrads = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) + np.asarray(b, np.float64),
        jg_head, jg_trunk)
    return dict(case=kind,
                jloss=jloss, jld=jld, jstats=jstats, jtemp=jtemp, jtgt=jtgt,
                jrows=jrows, jgrads=jgrads, jcol=jcol, jdepths=jdepths,
                jg_col=jg_col, loss=loss, ld=ld, model=tmodel,
                trunk_model=ttrunk, outs=outs, ttgt=ttgt,
                trows=_rows(outs), col=col, depths=depths, hcol=hcol)


def test_trunk_outputs_match_jax(step_run):
    r = step_run
    for got, ref in zip([r["col"]] + list(r["depths"]),
                        [r["jcol"]] + list(r["jdepths"])):
        ref = np.asarray(ref)
        err = np.abs(got.detach().numpy() - ref).max()
        assert err <= TRUNK_TOL * np.abs(ref).max(), err


def test_loss_dict_matches_jax(step_run):
    r = step_run
    assert set(r["ld"]) == set(r["jld"])
    for k, v in r["jld"].items():
        np.testing.assert_allclose(float(r["ld"][k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(r["loss"]), float(r["jloss"]),
                               rtol=1e-4)


def _numpy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def test_assignments_match_jax(step_run):
    """Each layer's assignment equal. On the pipeline batch alone, a
    permutation among queries whose outputs are bit-identical in both
    packages is allowed (the empty temporal instances of a cold bank
    are such queries there: every assignment among them is optimal,
    and each package breaks the tie its own way). The synthetic batch
    is held to exact equality."""
    r = step_run
    for kind, jt, tt, jrows, trows in (
            ("3d", r["jtgt"][0], r["ttgt"][0], r["jrows"][0], r["trows"][0]),
            ("2d", r["jtgt"][1], r["ttgt"][1], r["jrows"][1],
             r["trows"][1])):
        for layer, (j, t) in enumerate(zip(jt, tt)):
            j, t = np.asarray(j), t.numpy()
            flips = np.argwhere(j != t)
            msg = (f"{kind} layer {layer}: assignment flips at "
                   f"{flips[:4]}; JAX labels {j[tuple(flips[:4].T)]}, "
                   f"port {t[tuple(flips[:4].T)]}")
            if r["case"] == "synthetic":
                assert flips.size == 0, msg
                continue
            for b in np.unique(flips[:, 0]):
                q = flips[flips[:, 0] == b, 1]
                rows = [_numpy(x)[b] for pair in (jrows[layer],
                                                  trows[layer])
                        for x in pair]
                equal_rows = all(np.array_equal(x[i], x[q[0]])
                                 for x in rows for i in q)
                assert equal_rows and sorted(j[b, q]) == sorted(t[b, q]), \
                    msg


def _jax_leaf(tree, jpath):
    node = tree
    for k in jpath.split("/"):
        node = node[k]
    return np.asarray(node)


def test_gradients_and_batch_stats_match_jax(step_run):
    r = step_run
    tree = {"params": r["jgrads"], "batch_stats": r["jstats"]}
    model = r["model"]
    params = dict(model.named_parameters())
    trunk_params = dict(r["trunk_model"].named_parameters())
    state = r["trunk_model"].state_dict()
    # the gradient the head sends into the trunk
    ref = np.asarray(r["jg_col"])
    assert np.abs(r["hcol"].grad.numpy() - ref).max() <= \
        GRAD_TOL * np.abs(ref).max()
    checked = 0
    for prefix, mod in model.named_modules():
        for tname, jpath, (_, inverse) in _sources(mod, prefix):
            ref = _jax_leaf(tree, jpath)
            if jpath.startswith("batch_stats"):
                np.testing.assert_allclose(
                    inverse(state[tname].numpy()), ref, rtol=1e-5,
                    atol=1e-6, err_msg=tname)
            elif tname != "head.instance_feature":  # frozen, see above
                p = (trunk_params if tname.split(".")[0] in TRUNK_MODULES
                     else params)[tname]
                got = (inverse(p.grad.numpy()) if p.grad is not None
                       else np.zeros_like(ref))
                bound = GRAD_TOL * np.abs(ref).max() + GRAD_FLOOR
                assert np.abs(got - ref).max() <= bound, (
                    tname, np.abs(got - ref).max(), bound)
            checked += 1
    assert checked > 100


def test_carried_temporal_state_matches_jax(step_run):
    r = step_run
    t, j = r["outs"]["temporal_state"], r["jtemp"]
    for name in ("feature", "anchor", "confidence"):
        np.testing.assert_allclose(getattr(t, name).detach().numpy(),
                                   np.asarray(getattr(j, name)), atol=5e-4,
                                   rtol=1e-3, err_msg=name)
