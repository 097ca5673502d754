"""The port's training trunk against the JAX package, and a port-only
smoke of the tiny training step.

The module trunk (`ResNet.forward_train` at a 64x32 input, six images,
a block of each constant so that the stem's max-pool windows tie)
against `ResNet.apply(train=True, mutable=["batch_stats"])` at depth
26: the feature maps at 1e-5 of each one's largest value (fp32
convolutions and batch statistics summed in another order through 13
layers), the new `batch_stats` at 1e-5 relative, the gradient of every
trunk parameter at 2e-5 of its largest value (JAX's own gradients are up
to 9.1e-6 of it away from a float64 evaluation of the same trunk, the
port's 5.5e-6); with remat on, the same statistics and gradients bit for
bit. C5's batch statistics come from 6 x 1 x 2 values a channel, where
E[x^2] - E[x]^2 cancels: JAX's own C5 is 1.8e-5 of its largest value
away from a float64 evaluation (the port's 5e-6), and a loss on C5 moves
every gradient by up to 3e-5 of its largest value in JAX (1e-5 in the
port). So C5 is held at 1e-4, and the gradients are those of a loss on
C2-C4 (layer4's are then zero on both sides).

At depth 50 (whose identity blocks depth 26 lacks) in fp32 the forward
alone: C2 and the statistics of the stem and layer1 at 1e-5. Its fp32
gradients cannot be held to each other: with random weights the depth-50
backward in fp32 is ill-conditioned in both packages, whatever the input
size (flax's one-pass variance cancels where the residual stream's mean
outgrows its spread). At 64x32, 128x256 and 256x704 alike, JAX's own
fp32 gradients of layer4 are 13-30 % of their largest value away from a
float64 evaluation of the same trunk. So the depth-50 backward is held
to JAX in float64 on both sides, where the two packages compute the same
function: every feature map, every new batch statistic and the gradient
of every trunk parameter (layer4 and the identity blocks included, a
loss on C2-C5) at 1e-10 of the largest value (sums taken in another
order; 1.5e-12 seen).

The tiny step (`simpb_tiny` with the flagship's fast knobs) runs two
steps on the CPU with no JAX at all: finite losses, the JAX step's loss
keys (`loss_cls3d_dn_1` once the DN cache is carried), parameters moved
and the frozen instance feature not; and the entry point refuses to
start without a card unless the CPU is named.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.models.backbone import ResNet as JaxResNet
from simpb_tpu_torch.configs.base import TrainConfig, simpb_tiny
from simpb_tpu_torch.models.backbone import ResNet
from simpb_tpu_torch.training.train_step import (
    build_train_model, build_train_step, create_train_state, init_temporal,
)
from simpb_tpu_torch.utils.convert import (
    _sources, state_from_jax, to_jax_variables,
)
from simpb_tpu_torch.utils.synthetic import (
    batch_to_torch, synthetic_train_batch,
)

torch.set_num_threads(1)


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, leaf.shape)
        elif name == "mean":
            v = 0.1 * rng.normal(size=leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = 0.1 * rng.normal(size=leaf.shape)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


# (depth, levels the loss reads): depth 26 (one block a stage) with a
# loss on C2-C4; depth 50 (identity blocks too), whose forward alone is
# compared
TRUNK_CASES = {26: 3, 50: 1}


@functools.lru_cache(maxsize=None)
def _trunk_case(depth):
    levels = TRUNK_CASES[depth]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 32, 64, 3)).astype(np.float32)
    x[:, 4:20, 8:40] = 0.25  # a flat block: tied max-pool windows
    jnet = JaxResNet(depth=depth)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x,
                                              train=True))
    variables = _random_tree(shapes, 1)
    cots = [rng.normal(size=(6, 32 // s, 64 // s, 256 * s // 4)).astype(
        np.float32) * (lvl < levels) for lvl, s in enumerate((4, 8, 16, 32))]

    def loss(params, stats):
        feats, mut = jnet.apply({"params": params, "batch_stats": stats}, x,
                                train=True, mutable=["batch_stats"])
        return sum(jnp.sum(f * c) for f, c in zip(feats, cots)), (feats, mut)

    if depth == 50:  # the forward alone (see the module docstring)
        feats, mut = jax.jit(lambda v: jnet.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables)
        return depth, x, variables, cots, feats, mut["batch_stats"], None
    (_, (feats, mut)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"], variables["batch_stats"])
    return depth, x, variables, cots, feats, mut["batch_stats"], grads


def _run_port(case, remat):
    depth, x, variables, cots, *_ = case
    net = ResNet(depth)
    net.load_state_dict(state_from_jax(net, variables), strict=True)
    feats = net.forward_train(torch.from_numpy(x), torch.float32, remat=remat)
    loss = sum((f * torch.from_numpy(c)).sum() for f, c in zip(feats, cots))
    loss.backward()
    return net, feats


def _jax_leaf(tree, jpath):
    node = tree
    for k in jpath.split("/"):
        node = node[k]
    return np.asarray(node)


@pytest.mark.parametrize("depth", sorted(TRUNK_CASES))
def test_module_trunk_matches_jax_in_training_mode(depth):
    case = _trunk_case(depth)
    _, _, _, _, jfeats, jstats, jgrads = case
    net, feats = _run_port(case, remat=False)
    for lvl, (f, r) in enumerate(zip(feats, jfeats)):
        if lvl >= TRUNK_CASES[depth] + (depth == 26):
            continue
        r = np.asarray(r)
        frac = 1e-4 if lvl == 3 else 1e-5
        assert np.abs(f.detach().numpy() - r).max() <= frac * np.abs(r).max()
    checked = 0
    for prefix, mod in net.named_modules():
        for tname, jpath, (_, inverse) in _sources(mod, prefix):
            if depth == 50 and (tname.startswith(("layer2", "layer3",
                                                  "layer4"))
                                or jpath.startswith("params")):
                continue
            t = dict(net.named_parameters()).get(tname)
            if jpath.startswith("batch_stats"):
                got = net.state_dict()[tname].numpy()
                np.testing.assert_allclose(
                    inverse(got), _jax_leaf({"batch_stats": jstats}, jpath),
                    rtol=1e-5, atol=1e-6, err_msg=tname)
            else:
                ref = _jax_leaf({"params": jgrads}, jpath)
                got = inverse(t.grad.numpy() if t.grad is not None
                              else np.zeros(tuple(t.shape), np.float32))
                bound = 2e-5 * np.abs(ref).max()
                assert np.abs(got - ref).max() <= bound, tname
            checked += 1
    assert checked >= (len(net.state_dict()) - sum(
        1 for k in net.state_dict() if k.endswith("num_batches_tracked"))
        if depth == 26 else 2 * (1 + 3 * 3 + 1))


@functools.lru_cache(maxsize=None)
def _trunk50_float64():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 32, 64, 3))
    x[:, 4:20, 8:40] = 0.25
    cots = [rng.normal(size=(6, 32 // s, 64 // s, 256 * s // 4))
            for s in (4, 8, 16, 32)]
    with jax.enable_x64(True):
        jnet = JaxResNet(depth=50, dtype=jnp.float64)
        shapes = jax.eval_shape(lambda: jnet.init(
            jax.random.PRNGKey(0), x.astype(np.float32), train=True))
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), _random_tree(shapes, 1))

        def loss(params, stats):
            feats, mut = jnet.apply(
                {"params": params, "batch_stats": stats}, x, train=True,
                mutable=["batch_stats"])
            return (sum(jnp.sum(f * c) for f, c in zip(feats, cots)),
                    (feats, mut))

        (_, (feats, mut)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"],
                                 variables["batch_stats"])
        feats = [np.asarray(f) for f in feats]
        stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
    return x, variables, cots, feats, stats, grads


def test_module_trunk_depth50_backward_matches_jax_in_float64():
    x, variables, cots, jfeats, jstats, jgrads = _trunk50_float64()
    net = ResNet(50).double()
    net.load_state_dict(state_from_jax(net, variables), strict=True)
    feats = net.forward_train(torch.from_numpy(x), torch.float64)
    sum((f * torch.from_numpy(c)).sum() for f, c in zip(feats, cots)
        ).backward()
    for f, r in zip(feats, jfeats):
        assert np.abs(f.detach().numpy() - r).max() <= 1e-10 * np.abs(r).max()
    params = dict(net.named_parameters())
    checked = 0
    for prefix, mod in net.named_modules():
        for tname, jpath, (_, inverse) in _sources(mod, prefix):
            if jpath.startswith("batch_stats"):
                np.testing.assert_allclose(
                    inverse(net.state_dict()[tname].numpy()),
                    _jax_leaf({"batch_stats": jstats}, jpath),
                    rtol=1e-10, atol=1e-12, err_msg=tname)
            else:
                ref = _jax_leaf({"params": jgrads}, jpath)
                got = inverse(params[tname].grad.numpy())
                assert np.abs(ref).max() > 0, tname
                assert (np.abs(got - ref).max()
                        <= 1e-10 * np.abs(ref).max()), tname
            checked += 1
    assert checked == len(net.state_dict()) - sum(
        1 for k in net.state_dict() if k.endswith("num_batches_tracked"))


def test_module_trunk_remat_keeps_stats_and_gradients():
    case = _trunk_case(26)
    net0, f0 = _run_port(case, remat=False)
    net1, f1 = _run_port(case, remat=True)
    for a, b in zip(f0, f1):
        assert torch.equal(a, b)
    s0, s1 = net0.state_dict(), net1.state_dict()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k  # one update, not two
    p1 = dict(net1.named_parameters())
    for n, p in net0.named_parameters():
        assert torch.equal(p.grad, p1[n].grad), n


def _tiny_fast():
    cfg = simpb_tiny()
    head = dataclasses.replace(
        cfg.head, msda_patch_mode=True, msda_gather_capacity=6,
        dfa_gather_capacity=256, msda_sel_levels=2,
    )
    return dataclasses.replace(cfg, head=head)


def test_tiny_train_step_runs_two_steps_on_the_cpu():
    cfg = _tiny_fast()
    model = build_train_model(cfg, device="cpu", seed=0)
    tc = TrainConfig()
    state = create_train_state(model, tc)
    step = build_train_step(model, tc)
    batch = batch_to_torch(synthetic_train_batch(
        cfg, 1, seed=3, num_objects=8, max_gt3d=8, max_gt2d=6), "cpu")
    temporal, dn_state = init_temporal(cfg, 1, "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, temporal, dn_state, m1 = step(state, batch, temporal, dn_state, 7)
    assert np.isfinite(float(m1["loss"]))
    for k in ["loss_cls3d_0", "loss_box3d_5", "loss_cls2d_2",
              "loss_iou2d_0", "loss_cls3d_dn_3", "loss_box3d_dn_0",
              "loss_cls2d_dn_1", "loss_cns3d_0", "loss_yns3d_5",
              "loss_alpha2d_1", "loss_dense_depth"]:
        assert k in m1, k
    assert dn_state is not None and state.step == 1
    state, temporal, dn_state, m2 = step(state, batch, temporal, dn_state, 7)
    assert np.isfinite(float(m2["loss"])) and "loss_cls3d_dn_1" in m2
    after = dict(model.named_parameters())
    assert (after["head.anchor"] - before["head.anchor"]).abs().sum() > 0
    assert (after["img_backbone.conv1.weight"]
            - before["img_backbone.conv1.weight"]).abs().sum() > 0
    assert torch.equal(after["head.instance_feature"],
                       before["head.instance_feature"])
    # the updated parameters and statistics read back in the JAX layout
    tree = to_jax_variables(model)
    np.testing.assert_array_equal(
        tree["batch_stats"]["img_backbone"]["bn1"]["mean"],
        model.img_backbone.bn1.running_mean.numpy())
    np.testing.assert_array_equal(
        tree["params"]["depth_branch"]["depth_layer_0"]["kernel"][0, 0, :, 0],
        model.depth_branch.depth_layer_0.weight[0, :, 0, 0].detach().numpy())


def test_train_entry_point_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_fast()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_temporal(cfg, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_to_torch(synthetic_train_batch(
            cfg, 1, num_objects=2, max_gt3d=2, max_gt2d=2))
