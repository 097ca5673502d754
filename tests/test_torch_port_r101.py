"""ResNet-101, the space-to-depth stem and the module trunk at inference
against the JAX package, on the CPU at small sizes.

* The s2d stem (`models/backbone.py::stem_conv`) against JAX's
  `StemConv(s2d=True)` on a seeded [2, 32, 64, 3] image, eagerly: fp32
  within 1e-5 of the output's largest value, bf16 within 1e-2 of its
  range; the 7x7 kernel's and the image's gradients against `jax.grad`'s
  within 1e-5 of each gradient's largest value; the odd-size fallback to
  the 7x7/s2 conv.
* The module trunk at inference plus the module FPN against JAX's
  `ResNet(depth=26, stem_s2d=True).apply(train=False)` plus `FPN`, with
  non-trivial running statistics, one jitted JAX function (fp32 and
  bf16): each level within 1e-5 of its largest value in fp32 and within
  1e-2 of its range in bf16. The same jit captures the stem's BatchNorm
  output and the first bottleneck's, where XLA's excess precision shows
  bit for bit: JAX on the CPU feeds each conv's fp32 sum into its
  BatchNorm, where the JAX source (and the port, on `F.conv2d` in bf16)
  rounds it to bf16 first.
* `jax.eval_shape` of the depth-101 s2d tree converted with
  `from_jax_variables` and loaded `strict=True`; the port's depth-101
  module trunk against its depth-101 fused trunk (plain versions).
* The serving rule and the entry points' configs at r101; every kernel
  planner at the r101 shapes (ROADMAP C.4); the training data pipeline
  at r101's 1408x512 crop, which reaches outside the image, against
  JAX's, bit for bit.

Two `slow` tests: the test-mode pipeline at r101 (its crop lies inside
the image, as at r50), and the whole r101-fast slice (JAX `SimPB` at
depth 101 with `stem_s2d` and the tiny head) against the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs import base as jbase
from simpb_tpu.data import native_preprocess as jax_native
from simpb_tpu.data import transforms as JT
from simpb_tpu.data.dataset import NuScenesDataset as JaxDataset
from simpb_tpu.models.backbone import FPN as JaxFPN
from simpb_tpu.models.backbone import ResNet as JaxResNet
from simpb_tpu.models.backbone import StemConv
from simpb_tpu.models.detector import SimPB as JaxSimPB
from simpb_tpu_torch.configs import base as tbase
from simpb_tpu_torch.data.dataset import NuScenesDataset
from simpb_tpu_torch.models import backbone as tb
from simpb_tpu_torch.models.detector import (
    SimPB, check_serving_config, uses_fused_trunk,
)
from simpb_tpu_torch.ops import conv_fused, sampling
from simpb_tpu_torch.training import matching
from simpb_tpu_torch.utils.convert import (
    from_jax_variables, state_from_jax, to_jax_variables,
)
from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

torch.set_num_threads(1)
LEVELS = (4, 8, 16, 32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, ref):
    """Largest abs error over the reference's largest value."""
    return np.abs(got - ref).max() / np.abs(ref).max()


def _of_range(got, ref):
    """Largest abs error over the reference's range."""
    return np.abs(got - ref).max() / (ref.max() - ref.min())


def _random_tree(shapes, seed):
    """A JAX variable tree of seeded values: fan-in-scaled kernels and
    non-trivial BatchNorm scales, biases and running statistics."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif name == "mean":
            v = 0.1 * rng.normal(size=s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_stem(x, k, dtype=jnp.float32, s2d=True):
    return StemConv(features=64, s2d=s2d, dtype=dtype).apply(
        {"params": {"kernel": k}}, x)


def _is_call(mdl, method_name):
    return method_name == "__call__"


def _jax_side(rvars, fvars, x, k, cot, dtype_probe):
    """JAX's depth-26 s2d module trunk and FPN at inference, in the dtype
    of `dtype_probe`, with the captured outputs of its stem conv, of the
    stem's BatchNorm and of the first bottleneck; in fp32 also the s2d
    stem's image and kernel gradients of sum(StemConv(x, k) * cot)."""
    dtype = dtype_probe.dtype
    grads = {}
    if dtype == jnp.float32:
        grads = dict(zip(("gx", "gk"), jax.grad(lambda x, k: jnp.sum(
            _jax_stem(x, k) * cot), (0, 1))(x, k)))
    feats, inter = JaxResNet(depth=26, stem_s2d=True, dtype=dtype).apply(
        rvars, x, train=False, capture_intermediates=_is_call,
        mutable=["intermediates"])
    levels = JaxFPN(256, 4, dtype=dtype).apply(fvars, feats)
    inter = inter["intermediates"]
    f32 = lambda a: a.astype(jnp.float32)
    return dict(**grads, levels=[f32(o) for o in levels],
                **{name: f32(inter[mod]["__call__"][0]) for name, mod in (
                    ("stem", "conv1"), ("bn1", "bn1"),
                    ("block", "layer1_0"))})


@pytest.fixture(scope="module")
def case():
    """A seeded [2, 32, 64, 3] image, JAX's depth-26 s2d trunk and FPN
    variables (the stem kernel `k` among them) and a cotangent, and
    `_jax_side` of them in fp32 and bf16: one jit, two traces, compiled
    at XLA's backend optimisation level 0 (a third of level 2's time
    here; the HLO passes, excess precision among them, run as ever)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 16, 32, 64)).astype(np.float32)
    rvars = _random_tree(jax.eval_shape(lambda: JaxResNet(
        depth=26, stem_s2d=True).init(jax.random.PRNGKey(0), x)), 1)
    fvars = _random_tree(jax.eval_shape(lambda: JaxFPN(256, 4).init(
        jax.random.PRNGKey(0), [jnp.zeros((2, 32 // s, 64 // s, 64 * s))
                                for s in LEVELS])), 2)
    k = rvars["params"]["conv1"]["kernel"]
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        args = (rvars, fvars, x, k, cot, jnp.zeros((), dt))
        step = jax.jit(_jax_side).lower(*args).compile(
            {"xla_backend_optimization_level": 0})
        out[dt] = jax.tree_util.tree_map(np.asarray, step(*args))
    return x, k, cot, rvars, fvars, out


# ------------------------------------------------------------ s2d stem
def _port_stem(x, k, dtype=torch.float32, s2d=True):
    """NHWC image and HWIO kernel -> the port's stem conv, NHWC."""
    w = k.permute(3, 2, 0, 1) if torch.is_tensor(k) else \
        _t(k.transpose(3, 2, 0, 1))
    x = x if torch.is_tensor(x) else _t(x)
    return tb.stem_conv(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype),
                        s2d).permute(0, 2, 3, 1)


def test_s2d_kernel_places_every_tap():
    """Each 7x7 tap lands where JAX's loop puts it; the (cell 0, parity
    0) position of each axis holds zero."""
    w = torch.arange(2 * 3 * 49, dtype=torch.float32).reshape(2, 3, 7, 7)
    w2 = tb.s2d_stem_kernel(w)
    assert w2.shape == (2, 12, 4, 4)
    want = torch.zeros_like(w2)
    for ty in range(7):
        ay, by = (ty - 3) // 2 + 2, (ty - 3) % 2
        for tx in range(7):
            ax, bx = (tx - 3) // 2 + 2, (tx - 3) % 2
            ch = (by * 2 + bx) * 3
            want[:, ch:ch + 3, ay, ax] = w[:, :, ty, tx]
    assert torch.equal(w2, want)


def test_s2d_stem_matches_jax(case):
    x, k, _, _, _, out = case
    ref = out[jnp.float32]["stem"]
    got = _port_stem(x, k).numpy()
    assert got.shape == ref.shape == (2, 16, 32, 64)
    assert _rel(got, ref) <= 1e-5
    # the s2d formula and the 7x7/s2 conv are the same function
    assert _rel(_port_stem(x, k, s2d=False).numpy(), ref) <= 1e-5
    ref16 = out[jnp.bfloat16]["stem"]
    got16 = _port_stem(x, k, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert _of_range(got16.float().numpy(), ref16) <= 1e-2


def test_s2d_stem_gradients_match_jax(case):
    """The construction of the 4x4 kernel is differentiable: the image's
    and the 7x7 kernel's gradients equal `jax.grad`'s within 1e-5 of
    their largest values, and every tap gets one."""
    x, k, cot, _, _, out = case
    xt, kt = _t(x).requires_grad_(), _t(k).requires_grad_()
    (_port_stem(xt, kt) * _t(cot)).sum().backward()
    assert _rel(xt.grad.numpy(), out[jnp.float32]["gx"]) <= 1e-5
    assert _rel(kt.grad.numpy(), out[jnp.float32]["gk"]) <= 1e-5
    assert (kt.grad.abs().sum(dim=(2, 3)) > 0).all()


def test_s2d_stem_odd_sizes_fall_back(case):
    """An odd H or W takes the 7x7/s2 conv in both packages."""
    x, k = case[:2]
    for xo in (x[:, :31], x[:, :, :63]):
        ref = np.asarray(_jax_stem(xo, k))
        got = _port_stem(xo, k).numpy()
        assert got.shape == ref.shape
        assert _rel(got, ref) <= 1e-5
        np.testing.assert_array_equal(got,
                                      _port_stem(xo, k, s2d=False).numpy())


# --------------------------------------------------- the module trunk
def _port_trunk(rvars, fvars):
    net = tb.ResNet(26, stem_s2d=True)
    net.load_state_dict(state_from_jax(net, rvars), strict=True)
    fpn = tb.FPN()
    fpn.load_state_dict(state_from_jax(fpn, fvars), strict=True)
    return net.eval(), fpn.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_trunk_matches_jax(case, dtype):
    """fp32: each level within 1e-5 of its largest value; bf16: within
    1e-2 of its range (a bf16 ulp is 2^-8 of a value, and the two
    packages round the convs' outputs at other points: see
    test_module_trunk_rounds_where_the_source_does)."""
    x, _, _, rvars, fvars, out = case
    net, fpn = _port_trunk(rvars, fvars)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = fpn.forward_train(net.forward_module(_t(x), tdt), tdt)
    for lvl, (g, r) in enumerate(zip(got, out[getattr(jnp, dtype)][
            "levels"])):
        assert g.dtype == tdt and tuple(g.shape) == r.shape, lvl
        g = g.float().numpy()
        if dtype == "float32":
            assert _rel(g, r) <= 1e-5, lvl
        else:
            assert _of_range(g, r) <= 1e-2, lvl


def _fp32_sums(monkeypatch):
    """The port's module trunk with every conv's sum kept in fp32 (its
    operands rounded to the compute dtype): what XLA computes on the
    CPU."""
    def conv_fp32(mod, x, dtype):
        b = mod.bias.to(dtype).float() if mod.bias is not None else None
        return torch.nn.functional.conv2d(
            x.to(dtype).float(), mod.weight.to(dtype).float(), b,
            mod.stride, mod.padding)

    stem = tb.stem_conv
    monkeypatch.setattr(tb, "_conv", conv_fp32)
    monkeypatch.setattr(tb, "stem_conv",
                        lambda x, w, s2d: stem(x.float(), w.float(), s2d))


def test_module_trunk_rounds_where_the_source_does(case, monkeypatch):
    """XLA's excess precision on the CPU, bit for bit: JAX's bf16 stem
    BatchNorm and first bottleneck equal the port's arithmetic with each
    conv's sum kept in fp32 (up to a flip in ten thousand outputs, the
    fp32 sums' order), while the port as it serves, each conv rounded to
    bf16 before its BatchNorm as the JAX source writes it, differs in
    more than a tenth of them by a bf16 rounding."""
    x, _, _, rvars, fvars, out = case
    ref = out[jnp.bfloat16]
    net, _ = _port_trunk(rvars, fvars)
    bf = torch.bfloat16
    pooled = torch.nn.functional.max_pool2d(
        torch.relu(_t(ref["bn1"]).to(bf)).permute(0, 3, 1, 2), 3, 2, 1)

    def run():
        with torch.no_grad():
            stem = tb.batch_norm_infer(net._stem_module(_t(x), bf), net.bn1,
                                       bf)
            block = net.layer1_0.forward_module(pooled, bf)
        return [t.float().permute(0, 2, 3, 1).numpy() for t in (stem, block)]

    served = run()
    _fp32_sums(monkeypatch)
    kept = run()
    for want, s, k in zip((ref["bn1"], ref["block"]), served, kept):
        assert (k != want).mean() <= 1e-4
        assert (s != want).mean() >= 0.1
        assert _of_range(s, want) <= 1e-2


# ------------------------------------------------------------ depth 101
def _r101_tiny(base):
    """`base.simpb_tiny()` at depth 101 with the s2d stem (the r101-fast
    trunk at a 64x32 input)."""
    return dataclasses.replace(base.simpb_tiny(), backbone_depth=101,
                               stem_s2d=True)


def test_depth101_tree_converts_and_loads():
    """JAX's depth-101 s2d trunk tree (`jax.eval_shape` of its init, no
    compile), in a SimPB tree whose other leaves are the port's own
    (`to_jax_variables`), converts with `from_jax_variables` and loads
    strict: every leaf of the 33 bottlenecks and the stem has its
    counterpart, and no counterpart is left unfilled."""
    tcfg = _r101_tiny(tbase)
    shapes = jax.eval_shape(lambda: JaxResNet(depth=101, stem_s2d=True).init(
        jax.random.PRNGKey(0), jnp.zeros((6, 32, 64, 3))))
    trunk = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    assert len(trunk["params"]) == 2 + 33
    # the head's leaves from a depth-26 model (the same head), the trunk's
    # from JAX; loaded into a depth-101 model built on the meta device
    tree = to_jax_variables(SimPB(dataclasses.replace(tcfg,
                                                      backbone_depth=26)))
    for kind in ("params", "batch_stats"):
        tree[kind]["img_backbone"] = trunk[kind]
    with torch.device("meta"):
        model = SimPB(tcfg)
    model.load_state_dict(from_jax_variables(tree, tcfg), strict=True,
                          assign=True)
    assert not any(t.is_meta for t in model.state_dict().values())
    assert model.img_backbone.stem_s2d and not model.fused_trunk
    assert len(model.img_backbone.block_names) == 33
    assert (model.img_backbone.layer3_22.bn3.running_var == 0.5).all()


def _randomize_trunk(net, seed):
    """`net`'s convs fan-in-scaled and its BatchNorms non-trivial (scales,
    biases, running statistics), from a seeded torch generator: the
    scales of `randomize_` at a fifth of its cost on a depth-101 tree."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.normal_(0, mod.weight[0].numel() ** -0.5,
                                   generator=g)
                if mod.bias is not None:
                    mod.bias.normal_(0, 0.02, generator=g)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.normal_(1, 0.1, generator=g)
                mod.bias.normal_(0, 0.1, generator=g)
                mod.running_mean.normal_(0, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    return net.eval()


def test_depth101_module_trunk_matches_fused_trunk():
    """The depth-101 module trunk (7x7 and s2d stems) against the fused
    trunk, both through the kernels' plain versions on the CPU, fp32, at
    the tiny config's 64x32 input: each level within 1e-4 of its largest
    value (BatchNorm folded into the convs against unfolded, through 33
    blocks)."""
    net = _randomize_trunk(tb.ResNet(101), seed=3)
    fpn = _randomize_trunk(tb.FPN(), seed=4)
    assert (net.layer3_22.bn3.running_var != 1).all()
    x = torch.randn(1, 32, 64, 3, generator=torch.Generator().manual_seed(0))
    f32 = torch.float32
    with torch.no_grad():
        fused = fpn(net(x, f32), f32)
        module = fpn.forward_train(net.forward_module(x, f32), f32)
        net.stem_s2d = True
        s2d = fpn.forward_train(net.forward_module(x, f32), f32)
    for lvl, (f, m, s) in enumerate(zip(fused, module, s2d)):
        assert f.shape == m.shape == s.shape == (1, 8 // 2 ** lvl,
                                                 16 // 2 ** lvl, 256)
        assert _rel(m.numpy(), f.numpy()) <= 1e-4, lvl
        assert _rel(s.numpy(), f.numpy()) <= 1e-4, lvl


def test_serving_rule_and_r101_configs(monkeypatch):
    """JAX's rule (`detector.py:69-74`): the fused trunk iff
    `backbone_fused_infer` and not `stem_s2d`. Both r101 configs serve
    and train; `r101` under the eval CLI takes the fused trunk and
    `r101-fast` the module trunk; the bench's `SIMPB_FUSED_TRUNK=0` the
    module trunk."""
    from simpb_tpu_torch import bench
    from simpb_tpu_torch.tools import day0
    from simpb_tpu_torch.tools import test as test_cli
    from simpb_tpu_torch.tools import train as train_cli

    for fused, s2d, want in ((True, False, True), (True, True, False),
                             (False, False, False), (False, True, False)):
        cfg = dataclasses.replace(tbase.simpb_r50_704x256(),
                                  backbone_fused_infer=fused, stem_s2d=s2d)
        assert uses_fused_trunk(cfg) == want
    for name, fused in (("r101", True), ("r101-fast", False)):
        cfg = test_cli.build_config(test_cli.parse_args(
            ["--ann-file", "x", "--config", name]))
        check_serving_config(cfg)
        assert cfg.backbone_depth == 101 and cfg.input_size == (1408, 512)
        assert uses_fused_trunk(cfg) == fused
        tcfg = train_cli.build_config(train_cli.parse_args(
            ["--ann-file", "x", "--config", name]))
        assert tcfg.stem_s2d == (name == "r101-fast")
        assert train_cli.refused_flags(train_cli.parse_args(
            ["--ann-file", "x", "--config", name])) == []
    cfg = day0.measurement_config("r101")[0]
    assert cfg.backbone_depth == 101 and uses_fused_trunk(cfg)
    monkeypatch.setenv("SIMPB_FUSED_TRUNK", "0")
    assert not uses_fused_trunk(bench.config())


# ------------------------------------------------------------ C.4
R101_SHAPES = ((128, 352), (64, 176), (32, 88), (16, 44))
# ResNet stages: (mid channels, out channels, stride)
STAGES = ((64, 256, 4), (128, 512, 8), (256, 1024, 16), (512, 2048, 32))


@pytest.mark.parametrize("bs", [1, 4])
def test_every_planner_takes_r101(bs):
    """ROADMAP C.4 at r101: every kernel's planner plans the r101 shapes
    (none raises, so that the card never meets a refusal first). K2-K4
    bf16 at the stage maps of 1408x512 (bs 1 serving, bs 4 the
    multi-slot eval); DFA, MSDA-sel, exact MSDA, H1-H3, B, C and D at
    the 59,840-row column, serving (900 anchors, 208 / 256 slots) and
    training (DN rows: 1,220 anchors, 384 slots); A's 900 columns."""
    assert sum(h * w for h, w in R101_SHAPES) == 59840
    b, cin = 6 * bs, 64
    for cm, co, s in STAGES:
        prev = 4 if cin == 64 else s // 2
        conv_fused.plan_bottleneck_down_tc(b, 512 // prev, 1408 // prev, cin,
                                           cm, co, s // prev)
        conv_fused.plan_bottleneck_tc(b, 512 // s, 1408 // s, co, cm)
        conv_fused.plan_conv3x3_tc(b, 512 // s, 1408 // s, 256, 256)
        cin = co
    for anchors in (900, 900 + 5 * 2 * 32):  # serving; training with DN
        for cap in (2048, 2304, 4096):
            sampling.plan_dfa(bs, 6, anchors, 13, 8, 256, cap, R101_SHAPES)
            sampling.plan_dfa_backward(bs, 6, anchors, 13, 8, 256, cap,
                                       R101_SHAPES)
    # A's columns are the queries, whatever the resolution
    for make in (tbase.simpb_r101_1408x512, tbase.simpb_r101_1408x512_fast):
        assert make().head.num_anchor <= matching.MAX_COLS
    for levels, dtype in ((2, torch.float32), (2, torch.bfloat16),
                          (4, torch.float32), (4, torch.bfloat16)):
        sampling.plan_msda_sel(b, 208, 32, 8, 256, levels, 8, 8, dtype,
                               R101_SHAPES)  # MSDA-sel; H1 at 4 levels
    sampling.plan_msda_sel_backward(b, 208, 32, 8, 256, 2, 8, 8, R101_SHAPES)
    for q in (208, 256, 384):  # H2 on the exact plan; with DN slots
        sampling.plan_msda(b, q, 8, 4, 256, R101_SHAPES)
        sampling.plan_msda_backward(b, q, 8, 4, 256, R101_SHAPES)
        sampling.plan_clamp_priority(b, q, 8, 4, 8, 8, R101_SHAPES)
        for layout in (0, 1):  # H1 (bf16) in either layout
            sampling.plan_msda_levels(b, q, 8, 256, R101_SHAPES, layout)


# ------------------------------------------------------------ data
@pytest.fixture(scope="module")
def r101_set(tmp_path_factory):
    """One frame of six 1600x900 PNGs with 2D GT and LiDAR, and r101's
    test-mode and training augmentations (the CLIs'): the training
    resize of 0.40-0.47 gives ~704x396, so the 1408x512 crop starts
    above the image and reaches past its right edge."""
    from simpb_tpu_torch.tools import test as test_cli
    from simpb_tpu_torch.tools import train as train_cli

    d = tmp_path_factory.mktemp("r101_set")
    pkl = write_synthetic_infos(str(d), n_frames=1, gap_at=(),
                                src_hw=(900, 1600), num_objects=6,
                                write_images=True, with_2d=True,
                                with_lidar=True)
    cfg = tbase.simpb_r101_1408x512_fast()
    return (pkl, test_cli.eval_aug_conf(cfg, 900, 1600),
            train_cli.train_aug_conf(cfg, 900, 1600),
            cfg.strides[: cfg.num_depth_layers])


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_get_sample_at_r101_crop_matches_jax(r101_set, native):
    """Training mode (the trainer's, one seeded draw whose 1408x512 crop
    starts above the ~704x396 resized image and reaches past its right
    edge): the port's `get_sample` equals JAX's bit for bit. The native
    route's images are held to JAX's native pass (mean 0, std 1) and
    normalisation composed, as tests/test_torch_port_train_data.py holds
    them at r50. Test mode, whose crop lies inside the image, is the
    `slow` test below."""
    from test_torch_port_train_data import assert_same

    pkl, _, train_aug, strides = r101_set
    kw = dict(test_mode=False, data_aug_conf=train_aug, strides=strides)
    jds = JaxDataset(pkl, **kw)
    tds = NuScenesDataset(pkl, use_native=native, **kw)
    g1, g2 = np.random.default_rng(11), np.random.default_rng(11)
    aug1, aug2 = jds.get_augmentation(g1), tds.get_augmentation(g2)
    assert aug1 == aug2
    left, top, right, _ = aug2["crop"]
    assert top < 0 and right > 1600 * aug2["resize"]
    # no generator: the geometry without the photometric jitter, which
    # tests/test_torch_port_train_data.py holds at r50
    t = tds.get_sample(0, aug=aug2)
    j = jds.get_sample(0, aug=aug1)
    assert t["img"].shape == (6, 512, 1408, 3)
    if native:
        paths = jds.frame_geometry(jds.data_infos[0])["img_paths"]
        zero, one = np.zeros(3, np.float32), np.ones(3, np.float32)
        imgs = [jax_native.preprocess_image(im, aug1, mean=zero, std=one)
                for im in jds.load_images(paths, dtype=np.uint8)]
        assert_same(t.pop("img"), np.stack(JT.normalize_images(imgs)), "img")
        j.pop("img")
    assert_same(t, j)
    assert tds.route_counts["native" if native else "pil"] == 1


@pytest.mark.slow
@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_get_sample_at_r101_eval_crop_matches_jax(r101_set, native):
    """Test mode (the eval CLI's: resize 0.88, the bottom 1408x512 of the
    image): the port's `get_sample` equals JAX's bit for bit, as
    tests/test_torch_port_eval.py holds it at r50."""
    from test_torch_port_train_data import assert_same

    pkl, eval_aug, _, _ = r101_set
    kw = dict(test_mode=True, data_aug_conf=eval_aug, sequences_split_num=1)
    j = JaxDataset(pkl, use_native=native, **kw).get_sample(
        0, with_points=False)
    t = NuScenesDataset(pkl, use_native=native, **kw).get_sample(0)
    assert t["img"].shape == (6, 512, 1408, 3)
    for key in ("img", "projection_mat", "focal"):
        assert_same(t[key], j[key], key)


# ------------------------------------------------------------ slow
@pytest.mark.slow
def test_r101_fast_slice_matches_jax():
    """JAX `SimPB` at depth 101 with `stem_s2d` (the module trunk) and the
    tiny head, fp32, a cold frame and a stream frame, against the port
    (its module trunk, by the same rule) within 5e-4 (absolute and
    relative), the stream frame starting both from JAX's state."""
    from simpb_tpu_torch.models.instance_bank import TemporalState
    from test_torch_port_slice import _fast, _temp2cur, random_jax_variables
    from simpb_tpu.utils.synthetic import synthetic_rig

    jcfg = _fast(_r101_tiny(jbase), True)
    tcfg = _fast(_r101_tiny(tbase), True)
    rng = np.random.default_rng(2)
    imgs = rng.normal(size=(2, 1, 6, 32, 64, 3)).astype(np.float32)
    proj = synthetic_rig(1, (64, 32))
    jmodel = JaxSimPB(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(imgs[0]), jnp.asarray(proj),
        train=False))
    variables = random_jax_variables(shapes)
    tmodel = SimPB(tcfg)
    tmodel.load_state_dict(from_jax_variables(variables, tcfg), strict=True)
    tmodel.eval()
    assert not tmodel.fused_trunk
    cold = jax.jit(lambda v, i, p: jmodel.apply(v, i, p, train=False))
    ref = cold(variables, jnp.asarray(imgs[0]), jnp.asarray(proj))
    dt, t2c = np.full((1,), 0.5, np.float32), _temp2cur(0.05, 0.8, -0.3)
    ref2 = jax.jit(lambda v, i, p, s, d, t: jmodel.apply(
        v, i, p, temporal=s, time_interval=d, temp2cur=t, train=False))(
        variables, jnp.asarray(imgs[1]), jnp.asarray(proj),
        ref["temporal_state"], jnp.asarray(dt), jnp.asarray(t2c))
    state = ref["temporal_state"]
    kw = dict(temporal=TemporalState(**{
        k: torch.from_numpy(np.array(getattr(state, k)))
        for k in ("feature", "anchor", "confidence", "instance_id",
                  "prev_id")}), time_interval=_t(dt), temp2cur=_t(t2c))
    for r, got in ((ref, tmodel(_t(imgs[0]), _t(proj))),
                   (ref2, tmodel(_t(imgs[1]), _t(proj), **kw))):
        for key in ("prediction", "classification", "quality"):
            for lvl, (g, w) in enumerate(zip(got[key], r[key])):
                if w is None:
                    continue
                np.testing.assert_allclose(
                    g.float().numpy(), np.asarray(w), rtol=5e-4, atol=5e-4,
                    err_msg=f"{key} layer {lvl}")
