"""The port's bf16 frame against the JAX package: the stem's rounding
point, and the head's blocks one by one in bf16.

The stem: the port's bf16 stem (`ResNet.stem`) against the JAX fused
trunk's stem lines (`simpb_tpu/models/backbone.py:312-319`), jitted: one
conv, no model compile. XLA's excess precision feeds the fp32 conv sum
into the folded BN, so the port sums in fp32 too; the outputs are equal
bit for bit, where rounding the conv to bf16 first (the JAX source's
literal order) differs in about one output in seven.

The head: each block at `simpb_tiny` widths with `dtype=jnp.bfloat16` on
the JAX side and `torch.bfloat16` in the port, parameters float32 in
both (`pair` of tests/test_torch_port_blocks.py), inputs from numpy
seeds. Each output must have the JAX output's dtype and lie within 1e-2
of its largest magnitude, the bf16 rule: the two frameworks round bf16
at other points (XLA keeps chains of bf16 elementwise ops in fp32, and
fuses a Dense's bias into its product), one bf16 ulp being 2^-8 of a
value. The whole frame is `test_bf16_frame_matches_jax` (marked slow).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen

from simpb_tpu.models import layers as jl
from simpb_tpu.models.aggregation import ReWeight as JReWeight
from simpb_tpu.models.decoder3d import decode_boxes3d as j_decode
from simpb_tpu.models.det2d_blocks import (
    SparseBox2DEncoder as J2DEnc, SparseBox2DRefinementModule as J2DRef,
)
from simpb_tpu.models.det3d_blocks import (
    SparseBox3DEncoder as J3DEnc, SparseBox3DKeyPointsGenerator as JKps,
    SparseBox3DRefinementModule as J3DRef,
)
from simpb_tpu.models.dfa import DeformableFeatureAggregation as JDFA
from simpb_tpu.models.group_attn import (
    QueryGroupMSDA as JMSDA, QueryGroupSelfAttention as JQGSA,
)
from simpb_tpu.models.instance_bank import InstanceBank as JBank
from simpb_tpu.ops.conv_fused import fold_bn as j_fold_bn
from simpb_tpu.ops.format import SpatialShapes as JSS
from simpb_tpu.ops.sampling import make_pair_table
from simpb_tpu.utils.synthetic import synthetic_anchors, synthetic_rig
from simpb_tpu_torch.models import layers as tl
from simpb_tpu_torch.models.aggregation import ReWeight
from simpb_tpu_torch.models.backbone import ResNet
from simpb_tpu_torch.models.decoder3d import decode_boxes3d
from simpb_tpu_torch.models.det2d_blocks import (
    SparseBox2DEncoder, SparseBox2DRefinementModule,
)
from simpb_tpu_torch.models.det3d_blocks import (
    SparseBox3DEncoder, SparseBox3DKeyPointsGenerator,
    SparseBox3DRefinementModule,
)
from simpb_tpu_torch.models.dfa import DeformableFeatureAggregation
from simpb_tpu_torch.models.group_attn import (
    QueryGroupMSDA, QueryGroupSelfAttention,
)
from simpb_tpu_torch.models.instance_bank import InstanceBank
from simpb_tpu_torch.ops.conv_fused import fold_bn
from simpb_tpu_torch.ops.format import SpatialShapes
from simpb_tpu_torch.utils.convert import state_from_jax
from test_torch_port_blocks import _anchor, _rand, _t, japply, pair

JB, TB = jnp.bfloat16, torch.bfloat16
E, G, A, CAMS = 64, 4, 32, 6  # simpb_tiny: embed, groups, anchors, cams
torch.set_num_threads(1)


def _check(got, ref, msg=""):
    """Same dtype, and within 1e-2 of the JAX output's largest value."""
    r = np.asarray(ref)
    assert str(got.dtype).split(".")[-1] == str(r.dtype), (
        f"{msg}: {got.dtype} vs {r.dtype}")
    g, r = got.detach().float().numpy(), r.astype(np.float32)
    assert g.shape == r.shape, msg
    err, scale = np.abs(g - r).max(), np.abs(r).max()
    assert err <= 1e-2 * scale, f"{msg}: max abs err {err}, scale {scale}"


# ------------------------------------------------------------------ stem
def test_stem_rounds_where_jax_does():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(CAMS, 32, 64, 3)).astype(np.float32)
    k = (rng.normal(size=(7, 7, 3, 64)) / np.sqrt(147)).astype(np.float32)
    bn = {"scale": 1 + 0.1 * rng.normal(size=64),
          "bias": 0.05 * rng.normal(size=64)}
    st = {"mean": 0.1 * rng.normal(size=64),
          "var": rng.uniform(0.5, 1.5, 64)}
    bn, st = ({n: v.astype(np.float32) for n, v in d.items()}
              for d in (bn, st))

    def jax_stem(x, k, bn, st):  # simpb_tpu/models/backbone.py:312-319
        y = jax.lax.conv_general_dilated(
            x.astype(JB), k.astype(JB), (2, 2), ((3, 3), (3, 3)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        f, b = j_fold_bn(bn, st)
        return linen.relu((y.astype(jnp.float32) * f + b).astype(JB))

    ref = np.asarray(jax.jit(jax_stem)(x, k, bn, st).astype(jnp.float32))
    net = ResNet(26)
    with torch.no_grad():
        net.conv1.weight.copy_(_t(k.transpose(3, 2, 0, 1)))
        net.bn1.weight.copy_(_t(bn["scale"]))
        net.bn1.bias.copy_(_t(bn["bias"]))
        net.bn1.running_mean.copy_(_t(st["mean"]))
        net.bn1.running_var.copy_(_t(st["var"]))
        got = net.stem(_t(x), TB)
        assert got.dtype == TB and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.float().numpy(), ref)
        # the source's literal order, the conv rounded to bf16 before
        # the BN, is what the port did before: it misses often
        f, b = fold_bn(net.bn1)
        y = F.conv2d(_t(x).to(TB).permute(0, 3, 1, 2),
                     net.conv1.weight.to(TB), stride=2, padding=3)
        old = torch.relu((y.permute(0, 2, 3, 1).float() * f + b).to(TB))
    assert (old.float().numpy() != ref).mean() > 0.05


# ---------------------------------------------------------------- layers
def test_layers_bf16():
    rng = np.random.default_rng(10)
    x = _rand(rng, 2, 7, E)
    mlp, jmlp = tl.MLPStack(E, E, 2, 2, TB), jl.MLPStack(E, 2, 2, dtype=JB)
    v = pair(jmlp, mlp, jnp.asarray(x))
    _check(mlp(_t(x)), japply(jmlp, v, x), "MLPStack")

    ffn = tl.AsymmetricFFN(E, 2 * E, 4 * E, TB)
    jffn = jl.AsymmetricFFN(E, 2 * E, 4 * E, dtype=JB)
    xf = _rand(rng, 2, 7, 2 * E)
    v = pair(jffn, ffn, jnp.asarray(xf))
    _check(ffn(_t(xf)), japply(jffn, v, xf, deterministic=True), "FFN")

    ln, jln = tl.LayerNorm(E, TB), linen.LayerNorm(1e-5, dtype=JB)
    v = pair(jln, ln, jnp.asarray(x))
    _check(ln(_t(x).to(TB)), japply(jln, v, x.astype(JB)), "LayerNorm")

    logits = _rand(rng, 2, 3, 9).astype(JB)
    logits[0, 1] = -np.inf
    _check(tl.masked_softmax(_t(logits.astype(np.float32)).to(TB)),
           jax.jit(jl.masked_softmax)(logits), "masked_softmax")

    q, k, val = (_rand(rng, 2, n, 2 * E) for n in (6, 9, 9))
    mask = rng.uniform(size=(6, 9)) < 0.3
    mask[2] = True  # a fully masked row
    att = tl.ResidualAttention(2 * E, G, TB)
    jatt = jl.ResidualAttention(2 * E, G, dtype=JB)
    v = pair(jatt, att, jnp.asarray(q), jnp.asarray(k), jnp.asarray(val))
    _check(att(_t(q), _t(k), _t(val), attn_mask=_t(mask)),
           japply(jatt, v, q, k, val, attn_mask=mask), "attention")


# ----------------------------------------------------------- 3D / 2D blocks
def test_3d_blocks_bf16():
    rng = np.random.default_rng(11)
    a = _anchor(A)
    feat = _rand(rng, 1, A, E).astype(JB)
    emb = _rand(rng, 1, A, E).astype(JB)
    f_t, e_t = _t(feat.astype(np.float32)).to(TB), _t(
        emb.astype(np.float32)).to(TB)
    enc = SparseBox3DEncoder((E // 2, E // 8, E // 8, E // 4), dtype=TB)
    jenc = J3DEnc(embed_dims=(E // 2, E // 8, E // 8, E // 4), dtype=JB)
    v = pair(jenc, enc, jnp.asarray(a))
    _check(enc(_t(a)), japply(jenc, v, a), "encoder")

    ref3d = SparseBox3DRefinementModule(E, num_cls=10, dtype=TB)
    jref3d = J3DRef(embed_dims=E, num_cls=10, dtype=JB)
    dt = np.array([0.4], np.float32)
    v = pair(jref3d, ref3d, jnp.asarray(feat), jnp.asarray(a),
             jnp.asarray(emb), time_interval=jnp.asarray(dt))
    got = ref3d(f_t, _t(a), e_t, _t(dt), True)
    ref = japply(jref3d, v, feat, a, emb, dt, return_cls=True)
    for g, r, name in zip(got, ref, ("anchor", "cls", "quality")):
        _check(g, r, name)

    kps = SparseBox3DKeyPointsGenerator(E, 6, TB)
    jkps = JKps(num_learnable_pts=6, dtype=JB)
    v = pair(jkps, kps, jnp.asarray(a), jnp.asarray(feat))
    _check(kps(_t(a), f_t), japply(jkps, v, a, feat), "keypoints")


def test_2d_blocks_and_reweight_bf16():
    rng = np.random.default_rng(12)
    q2 = CAMS * 8
    box = rng.uniform(0.05, 0.95, (1, q2, 2)).astype(np.float32)
    feat = _rand(rng, 1, q2, E).astype(JB)
    emb = _rand(rng, 1, q2, E).astype(JB)
    f_t, e_t = (_t(z.astype(np.float32)).to(TB) for z in (feat, emb))
    enc = SparseBox2DEncoder(E, TB)
    jenc = J2DEnc(embed_dims=E, dtype=JB)
    v = pair(jenc, enc, jnp.asarray(box))
    _check(enc(_t(box)), japply(jenc, v, box), "encoder2d")

    r2d = SparseBox2DRefinementModule(E, num_cls=10, dtype=TB)
    jr2d = J2DRef(embed_dims=E, num_cls=10, dtype=JB)
    v = pair(jr2d, r2d, jnp.asarray(feat), jnp.asarray(box),
             jnp.asarray(emb))
    got = r2d(f_t, _t(box), e_t)
    ref = japply(jr2d, v, feat, box, emb, return_cls=True)
    for g, r, name in zip(got, (ref[0], ref[1], ref[3]),
                          ("box", "cls", "alpha")):
        _check(g, r, name)

    trans = (rng.uniform(size=(1, q2, A)) < 0.1).astype(np.float32)
    center = trans * (rng.uniform(size=trans.shape) < 0.5)
    rw, jrw = ReWeight(E, TB), JReWeight(f_dim=E, dtype=JB)
    v = pair(jrw, rw, jnp.asarray(feat), jnp.asarray(emb),
             jnp.asarray(trans), jnp.asarray(center))
    got = rw(f_t, e_t, _t(trans), _t(center))
    ref = japply(jrw, v, feat, emb, trans, center)
    _check(got[0], ref[0], "reweight query")
    _check(got[1], ref[1], "reweight pos")


# -------------------------------------------------------- group attention
def test_query_group_self_attention_bf16():
    rng = np.random.default_rng(13)
    q = _rand(rng, 1, CAMS * 8, 2 * E).astype(JB)
    val = _rand(rng, 1, CAMS * 8, 2 * E).astype(JB)
    valid = rng.uniform(size=(1, CAMS * 8)) < 0.6
    valid[0, 8:16] = False  # a camera with no valid slot
    sa = QueryGroupSelfAttention(2 * E, G, CAMS, TB)
    jsa = JQGSA(embed_dims=2 * E, num_heads=G, num_cams=CAMS, dtype=JB)
    v = pair(jsa, sa, jnp.asarray(q), jnp.asarray(val), jnp.asarray(valid))
    got = sa(*(_t(z.astype(np.float32)).to(TB) for z in (q, val)),
             _t(valid))
    _check(got, japply(jsa, v, q, val, valid, deterministic=True), "qg sa")


@pytest.mark.parametrize("shapes,cap", [
    (((16, 24), (8, 12), (8, 8), (8, 10)), 5),
    (((8, 16), (4, 8), (2, 4), (1, 2)), None),
])
def test_query_group_msda_bf16(shapes, cap):
    """The serving path (top-2 level windows with slot compaction, or
    the per-level fallback of the tiny pyramid), bf16 layers around the
    sampling op, which takes float32 locations and weights."""
    rng = np.random.default_rng(14)
    k = 8
    ss_j, ss_t = JSS(shapes), SpatialShapes(shapes)
    q = _rand(rng, 1, CAMS * k, E).astype(JB)
    qpos = _rand(rng, 1, CAMS * k, E).astype(JB)
    ref_pts = rng.uniform(0.05, 0.95, (1, CAMS * k, 2)).astype(np.float32)
    depth = ((rng.uniform(size=(1, CAMS * k, 1)) < 0.7)
             * rng.uniform(1, 30, (1, CAMS * k, 1))).astype(np.float32)
    col = _rand(rng, 1, CAMS, ss_j.total, E).astype(JB)
    msda = QueryGroupMSDA(E, G, 4, 4, CAMS, gather_capacity=cap,
                          sel_levels=2, dtype=TB)
    jmsda = JMSDA(embed_dims=E, num_heads=G, num_levels=4, num_cams=CAMS,
                  patch_mode=True, gather_capacity=cap, sel_levels=2,
                  dtype=JB)
    pt = make_pair_table(jnp.asarray(col).reshape(-1, E))
    v = pair(jmsda, msda, jnp.asarray(q), jnp.asarray(qpos),
             jnp.asarray(ref_pts), jnp.asarray(depth), jnp.asarray(col),
             ss_j, pair_table=pt)
    # a visible sampling pattern: offsets and weights away from 0
    rng2 = np.random.default_rng(15)
    for name in ("sampling_offsets", "attention_weights"):
        kern = v["params"][name]["kernel"]
        v["params"][name]["kernel"] = (0.5 * rng2.normal(size=kern.shape)
                                       ).astype(np.float32)
    msda.load_state_dict(state_from_jax(msda, v, unused_ok=None),
                         strict=True)
    ref = jax.jit(lambda v_, *a: jmsda.apply(
        v_, *a, ss_j, deterministic=True, pair_table=make_pair_table(
            a[-1].reshape(-1, E))))(v, q, qpos, ref_pts, depth, col)
    got = msda(*(_t(z.astype(np.float32)).to(TB) for z in (q, qpos)),
               _t(ref_pts), _t(depth),
               _t(col.astype(np.float32)).to(TB), ss_t)
    _check(got, ref, "msda")


def test_dfa_bf16():
    rng = np.random.default_rng(16)
    shapes = ((8, 16), (4, 8), (2, 4), (1, 2))
    a = synthetic_anchors(A, 2)[None]
    feat = _rand(rng, 1, A, E).astype(JB)
    emb = _rand(rng, 1, A, E).astype(JB)
    col = _rand(rng, 1, CAMS, JSS(shapes).total, E).astype(JB)
    proj = synthetic_rig(1, (64, 32))
    wh = np.full((1, CAMS, 2), (64.0, 32.0), np.float32)
    dfa = DeformableFeatureAggregation(E, G, 4, CAMS, 6, gather_capacity=256,
                                       dtype=TB)
    jdfa = JDFA(embed_dims=E, num_groups=G, num_levels=4, num_cams=CAMS,
                gather_capacity=256, dtype=JB)
    v = pair(jdfa, dfa, jnp.asarray(feat), jnp.asarray(a), jnp.asarray(emb),
             jnp.asarray(col), JSS(shapes), jnp.asarray(proj),
             jnp.asarray(wh))
    ref = jax.jit(lambda v_, f, an, e, c, p, w: jdfa.apply(
        v_, f, an, e, c, JSS(shapes), p, w, deterministic=True,
        pair_table=make_pair_table(c.reshape(-1, E))))(
        v, feat, a, emb, col, proj, wh)
    got = dfa(*(_t(z.astype(np.float32)).to(TB) for z in (feat,)), _t(a),
              _t(emb.astype(np.float32)).to(TB),
              _t(col.astype(np.float32)).to(TB), SpatialShapes(shapes),
              _t(proj), _t(wh))
    _check(got, ref, "dfa")


# ------------------------------------------------ instance bank and decode
def test_bank_and_decode_bf16():
    """The carried state stays float32 under a bf16 head; selections
    over bf16 confidences match exactly where they do not tie."""
    rng = np.random.default_rng(17)
    bs, t = 1, 16
    kw = dict(num_anchor=A, num_temp_instances=t, embed_dims=E)
    jb, tb = JBank(**kw), InstanceBank(**kw)
    inst = _rand(rng, bs, A, E).astype(JB)
    anch = _anchor(A, 5)
    # each anchor's best class 0.25 apart from any other anchor's, the
    # rest below it: confidences that tie in neither package (JAX takes
    # the sigmoid through a bf16 exp and sum and divides in fp32)
    best = rng.permutation(A) * 0.25 - 3.875
    logits = best[None, :, None] - rng.uniform(0.5, 2.0, (bs, A, 10))
    logits[0, np.arange(A), rng.integers(0, 10, A)] = best
    logits = logits.astype(JB)
    quality = _rand(rng, bs, A, 2).astype(JB)
    temp_f = _rand(rng, bs, t, E)
    temp_a = _anchor(t, 6)
    mask = np.array([True])
    to_t = lambda z: _t(z.astype(np.float32)).to(TB)
    ju = jax.jit(jb.update)(inst, anch, logits, temp_f, temp_a, mask)
    tu = tb.update(to_t(inst), _t(anch), to_t(logits), _t(temp_f),
                   _t(temp_a), _t(mask))
    for g, r, name in zip(tu, ju, ("feature", "anchor")):
        _check(g, r, f"update {name}")

    jc, jconf = jax.jit(jb.cache)(inst, anch, logits, None, None)
    tc, tconf = tb.cache(to_t(inst), _t(anch), to_t(logits), None, None)
    _check(tconf, jconf, "cache confidence")
    for name in ("feature", "anchor", "confidence"):
        assert getattr(tc, name).dtype == torch.float32, name
        _check(getattr(tc, name), getattr(jc, name), f"cache {name}")
    jid, jst = jax.jit(lambda *z: jb.assign_instance_ids(
        *z, threshold=0.3))(logits, jc, jconf)
    tid, tst = tb.assign_instance_ids(to_t(logits), tc, tconf, threshold=0.3)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tst.instance_id.numpy(),
                                  np.asarray(jst.instance_id))

    kw = dict(num_output=16, score_threshold=0.3)
    jd = jax.jit(lambda *z: j_decode(*z, **kw))(
        logits, anch, jid, quality)
    td = decode_boxes3d(to_t(logits), _t(anch), instance_id=tid,
                        quality=to_t(quality), **kw)
    # the quality re-sort multiplies bf16 scores, which XLA rounds at
    # other points: near-equal products may swap, so the detections are
    # compared anchor by anchor
    by_t = td["anchor_idx"][0].argsort()
    by_j = np.argsort(np.asarray(jd["anchor_idx"])[0])
    for key in ("anchor_idx", "labels_3d", "valid", "instance_ids"):
        np.testing.assert_array_equal(td[key][0][by_t].numpy(),
                                      np.asarray(jd[key])[0][by_j],
                                      err_msg=key)
    for key in ("boxes_3d", "scores_3d", "cls_scores"):
        _check(td[key][0][by_t], np.asarray(jd[key])[0][by_j], key)


# ------------------------------------------------------------ whole frame
# pre-update outputs (the first 2D layer, the first refine3d) of every
# frame, max abs: the JAX package's own bf16 module-vs-fused trunk gap
# of the last layer with the head in fp32 (ROADMAP Queue C.1), for
# prediction, classification, quality (2D: the same three in order)
PRE_UPDATE_TOL = {"prediction": 0.11, "classification": 0.16,
                  "quality": 0.12}
# cold frame, every layer: the port's relative L2 gap to the JAX fused
# route at most this times the JAX module route's own gap
OWN_GAP_RATIO = 1.5
KEYS3D = ("prediction", "classification", "quality")
KEYS2D = ("prediction2d", "classification2d", "prediction_alpha2d")


@pytest.mark.slow
def test_bf16_frame_matches_jax():
    """The frame as bench.py serves it, at tiny size: bf16 fused trunk
    and bf16 head, a cold frame and two stream frames, through the port
    and through the JAX package with its fused trunk (Pallas in
    interpret mode, the reference) and its module trunk (the yardstick).
    Each frame starts both packages from JAX's incoming state.

    * Every output before the instance bank's first update (the first 2D
      layer and the first refine3d of each frame) within PRE_UPDATE_TOL,
      max abs (measured: at most a third of it).
    * The cold frame has no update. There a bf16 rounding now and then
      flips a top-2 level choice or moves a window by a pixel, in both
      of the JAX package's routes: their largest differences reach
      0.18 / 0.17 / 0.23 (prediction / classification / quality) and
      0.9 on a 2D classification, and which element flips changes with
      torch's thread count. So every layer of it is held by its relative
      L2 gap to the fused route, pooled over the layers: at most
      OWN_GAP_RATIO times the module route's (measured: 0.6-1.25 times).
    * After a stream frame's update the two JAX routes' predictions
      differ by tens of metres: a rounding reorders near-equal
      confidences in the bank's top-k, and other instances go on. Those
      layers are held by the instance ids alone, which must be equal.
    """
    from simpb_tpu.configs.base import simpb_tiny as jax_tiny
    from simpb_tpu.models.detector import SimPB as JaxSimPB
    from simpb_tpu_torch.configs.base import simpb_tiny
    from simpb_tpu_torch.models.detector import SimPB
    from simpb_tpu_torch.models.instance_bank import TemporalState
    from simpb_tpu_torch.utils.convert import from_jax_variables
    from test_torch_port_slice import _fast, _temp2cur, random_jax_variables

    bf = dict(compute_dtype="bfloat16", head_dtype="bfloat16")
    jcfgs = {fused: dataclasses.replace(_fast(jax_tiny(), fused), **bf)
             for fused in (True, False)}
    tcfg = dataclasses.replace(_fast(simpb_tiny(), True), **bf)
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(3, 1, CAMS, 32, 64, 3)).astype(np.float32)
    proj = synthetic_rig(1, (64, 32))
    dts = [np.full((1,), 0.5, np.float32), np.full((1,), 0.4, np.float32)]
    t2cs = [_temp2cur(0.05, 0.8, -0.3), _temp2cur(-0.02, 0.5, 0.1)]

    jmodels = {f: JaxSimPB(c) for f, c in jcfgs.items()}
    shapes = jax.eval_shape(lambda: jmodels[True].init(
        jax.random.PRNGKey(0), jnp.asarray(imgs[0]), jnp.asarray(proj),
        train=False))
    variables = random_jax_variables(shapes)
    tmodel = SimPB(tcfg)
    tmodel.load_state_dict(from_jax_variables(variables, tcfg), strict=True)
    tmodel.eval()
    steps = {f: (jax.jit(lambda v, i, p, m=m: m.apply(v, i, p, train=False)),
                 jax.jit(lambda v, i, p, s, dt, t, m=m: m.apply(
                     v, i, p, temporal=s, time_interval=dt, temp2cur=t,
                     train=False)))
             for f, m in jmodels.items()}

    def flat(outs):  # every layer of one output, float32, end to end
        return np.concatenate([
            (x.float().numpy() if torch.is_tensor(x)
             else np.asarray(x, np.float32)).ravel()
            for x in outs if x is not None])

    state = None
    for f in range(3):
        args = (variables, jnp.asarray(imgs[f]), jnp.asarray(proj))
        kw = {}
        if f:
            args += (state, jnp.asarray(dts[f - 1]), jnp.asarray(t2cs[f - 1]))
            kw = dict(
                temporal=TemporalState(**{
                    k: _t(getattr(state, k)) for k in (
                        "feature", "anchor", "confidence", "instance_id",
                        "prev_id")}),
                time_interval=_t(dts[f - 1]), temp2cur=_t(t2cs[f - 1]))
        ref, mod = (jax.tree_util.tree_map(
            np.asarray, steps[fused][1 if f else 0](*args))
            for fused in (True, False))
        got = tmodel(_t(imgs[f]), _t(proj), **kw)
        for key, tol in zip(KEYS3D + KEYS2D,
                            2 * tuple(PRE_UPDATE_TOL.values())):
            assert str(got[key][0].dtype).split(".")[-1] == str(
                ref[key][0].dtype), key
            g = np.abs(flat(got[key][:1]) - flat(ref[key][:1])).max()
            print(f"frame {f} {key} layer 0: max abs gap {g:.4f}")
            assert g <= tol, f"frame {f} {key} layer 0: {g} > {tol}"
        if f == 0:
            for key in KEYS3D + KEYS2D:
                r = flat(ref[key])
                rel = lambda x: np.linalg.norm(flat(x) - r) / np.linalg.norm(r)
                port, own = rel(got[key]), rel(mod[key])
                print(f"cold frame {key}: relative L2 gap {port:.4f}, the "
                      f"module route's {own:.4f}")
                assert port <= OWN_GAP_RATIO * own, (
                    f"cold frame {key}: relative L2 gap {port}, the JAX "
                    f"module route's {own}")
        for key in KEYS3D + KEYS2D:
            last = lambda outs: flat(outs[-1:])
            print(f"frame {f} {key} last layer: max abs gap "
                  f"{np.abs(last(got[key]) - last(ref[key])).max():.4f}, "
                  f"the module route's "
                  f"{np.abs(last(mod[key]) - last(ref[key])).max():.4f}")
        np.testing.assert_array_equal(got["instance_id"].numpy(),
                                      ref["instance_id"])
        state = ref["temporal_state"]
