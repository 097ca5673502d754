"""The port's head blocks against the JAX package, module by module:
layers, the 3D / 2D encoders and refinement modules, the keypoint
generator, ReWeight, allocation, query-group attention (self and the
windowed MSDA on its serving path), DFA, and the instance-bank
transitions.

Each JAX module's variable tree takes its shapes from `jax.eval_shape`
and its values from a numpy seed; `state_from_jax` converts it and the
port's module loads it with strict=True. Inputs come from numpy seeds.
Tolerance: 1e-5 in fp32 per block (a few dozen float32 roundings; the
JAX side is jitted, the port eager), 1e-4 where a block chains several
matmuls over values of order 10.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.models import layers as jl
from simpb_tpu.models.aggregation import ReWeight as JReWeight
from simpb_tpu.models.allocation import allocate_queries as j_alloc
from simpb_tpu.models.allocation import dispatch_to_2d as j_dispatch
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
from simpb_tpu.models.instance_bank import TemporalState as JState
from simpb_tpu.models.instance_bank import topk_gather as j_topk_gather
from simpb_tpu.ops.format import SpatialShapes as JSS
from simpb_tpu.ops.sampling import make_pair_table
from simpb_tpu.utils.synthetic import synthetic_anchors, synthetic_rig
from simpb_tpu_torch.models import layers as tl
from simpb_tpu_torch.models.aggregation import ReWeight
from simpb_tpu_torch.models.allocation import allocate_queries, dispatch_to_2d
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
from simpb_tpu_torch.models.instance_bank import (
    InstanceBank, TemporalState, topk_gather,
)
from simpb_tpu_torch.ops.format import SpatialShapes
from simpb_tpu_torch.utils.convert import state_from_jax

ATOL = 1e-5
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol, err_msg=msg)


def pair(jmod, tmod, *init_args, seed=0, **init_kw):
    """Seeded variables for `jmod`, loaded into `tmod` (strict)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *init_args, **init_kw))

    def fill(path, leaf):
        name, n = str(getattr(path[-1], "key", path[-1])), leaf.shape
        if name == "kernel":
            v = rng.normal(size=n) / np.sqrt(np.prod(n[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=n)
        else:
            v = 0.1 * rng.normal(size=n)
        return np.asarray(v, np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    tmod.load_state_dict(state_from_jax(tmod, v, unused_ok=None),
                         strict=True)
    return v


def japply(jmod, v, *args, **kw):
    """jmod.apply, jitted over the array arguments."""
    return jax.jit(lambda v_, *a: jmod.apply(v_, *a, **kw))(v, *args)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- layers
def test_layers():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 8)
    mlp = tl.MLPStack(8, 16, 2, 2)
    v = pair(jl.MLPStack(16, 2, 2), mlp, jnp.asarray(x))
    _close(mlp(_t(x)), japply(jl.MLPStack(16, 2, 2), v, x))

    logits = _rand(rng, 2, 3, 4)
    logits[0, 1] = -np.inf  # a fully masked row -> zeros
    logits[1, 0, :2] = -np.inf
    got = tl.masked_softmax(_t(logits))
    _close(got, jax.jit(jl.masked_softmax)(logits))
    assert (got[0, 1] == 0).all()

    ffn = tl.AsymmetricFFN(16, 32, 64)
    xf = _rand(rng, 2, 5, 32)
    jffn = jl.AsymmetricFFN(16, 32, 64)
    v = pair(jffn, ffn, jnp.asarray(xf))
    _close(ffn(_t(xf)), japply(jffn, v, xf, deterministic=True))

    pos = rng.uniform(size=(3, 7, 2)).astype(np.float32)
    _close(tl.pos2posemb2d(_t(pos), 16),
           jax.jit(lambda x: jl.pos2posemb2d(x, 16))(pos))
    p = np.array([0.0, 1e-7, 0.3, 1.0, 1.2], np.float32)
    _close(tl.inverse_sigmoid(_t(p)), jax.jit(jl.inverse_sigmoid)(p))


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_attention(mask_kind):
    rng = np.random.default_rng(1)
    q, k, val = _rand(rng, 2, 6, 16), _rand(rng, 2, 9, 16), _rand(rng, 2, 9, 16)
    qpos, kpos = _rand(rng, 2, 6, 16), _rand(rng, 2, 9, 16)
    if mask_kind == "bool":
        mask = rng.uniform(size=(6, 9)) < 0.3
        mask[2] = True  # fully masked query row
    else:
        mask = np.where(rng.uniform(size=(2, 6, 9)) < 0.3, -np.inf,
                        0.0).astype(np.float32)
        mask[1, 3] = -np.inf
    att = tl.ResidualAttention(16, 4)
    jatt = jl.ResidualAttention(16, 4)
    v = pair(jatt, att, jnp.asarray(q), jnp.asarray(k), jnp.asarray(val))
    got = att(_t(q), _t(k), _t(val), _t(qpos), _t(kpos), attn_mask=_t(mask))
    ref = japply(jatt, v, q, k, val, qpos, kpos, mask)
    _close(got, ref)


# ----------------------------------------------------------- 3D / 2D blocks
def _anchor(n, seed=0):
    a = synthetic_anchors(n, seed)[None]
    a[..., 8:] = np.random.default_rng(seed).normal(size=(1, n, 3))
    return a.astype(np.float32)


def test_3d_blocks():
    rng = np.random.default_rng(2)
    a = _anchor(12)
    feat, emb = _rand(rng, 1, 12, 16), _rand(rng, 1, 12, 16)
    enc = SparseBox3DEncoder((8, 2, 2, 4))
    jenc = J3DEnc(embed_dims=(8, 2, 2, 4))
    v = pair(jenc, enc, jnp.asarray(a))
    _close(enc(_t(a)), japply(jenc, v, a))

    ref3d = SparseBox3DRefinementModule(16, num_cls=10)
    jref3d = J3DRef(embed_dims=16, num_cls=10)
    dt = np.array([0.4], np.float32)
    v = pair(jref3d, ref3d, jnp.asarray(feat), jnp.asarray(a),
             jnp.asarray(emb), time_interval=jnp.asarray(dt))
    got = ref3d(_t(feat), _t(a), _t(emb), _t(dt), True)
    ref = japply(jref3d, v, feat, a, emb, dt, return_cls=True)
    for g, r, name in zip(got, ref, ("anchor", "cls", "quality")):
        _close(g, r, atol=1e-4, msg=name)

    kps = SparseBox3DKeyPointsGenerator(16, 6)
    jkps = JKps(num_learnable_pts=6)
    v = pair(jkps, kps, jnp.asarray(a), jnp.asarray(feat))
    _close(kps(_t(a), _t(feat)), japply(jkps, v, a, feat), atol=1e-4)


def test_2d_blocks_and_reweight():
    rng = np.random.default_rng(3)
    box = rng.uniform(0.05, 0.95, (1, 10, 2)).astype(np.float32)
    feat, emb = _rand(rng, 1, 10, 16), _rand(rng, 1, 10, 16)
    enc = SparseBox2DEncoder(16)
    v = pair(J2DEnc(embed_dims=16), enc, jnp.asarray(box))
    _close(enc(_t(box)), japply(J2DEnc(embed_dims=16), v, box))

    r2d = SparseBox2DRefinementModule(16, num_cls=10)
    jr2d = J2DRef(embed_dims=16, num_cls=10)
    v = pair(jr2d, r2d, jnp.asarray(feat), jnp.asarray(box), jnp.asarray(emb))
    got = r2d(_t(feat), _t(box), _t(emb))
    ref = japply(jr2d, v, feat, box, emb, return_cls=True)
    for g, r, name in zip(got, (ref[0], ref[1], ref[3]),
                          ("box", "cls", "alpha")):
        _close(g, r, msg=name)

    trans = (rng.uniform(size=(1, 10, 4)) < 0.4).astype(np.float32)
    center = trans * (rng.uniform(size=trans.shape) < 0.5)
    rw = ReWeight(16)
    v = pair(JReWeight(f_dim=16), rw, jnp.asarray(feat), jnp.asarray(emb),
             jnp.asarray(trans), jnp.asarray(center))
    got = rw(_t(feat), _t(emb), _t(trans), _t(center))
    ref = japply(JReWeight(f_dim=16), v, feat, emb, trans, center)
    _close(got[0], ref[0])
    _close(got[1], ref[1])


# ------------------------------------------------------------- allocation
def test_allocation_and_dispatch():
    a = synthetic_anchors(24, 1)[None]
    proj = synthetic_rig(1, (64, 32))
    got = allocate_queries(_t(a), _t(proj), (64, 32), capacity=10)
    ref = jax.jit(lambda a_, p_: j_alloc(a_, p_, (64, 32), capacity=10))(
        a, proj)
    for name in ("parent_idx", "valid", "center_flag", "trans_matrix",
                 "center_matrix"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    _close(got.anchor2d, ref.anchor2d)
    _close(got.ref_depth, ref.ref_depth, atol=1e-4)
    assert got.valid.any() and not got.valid.all()
    feat = _rand(np.random.default_rng(4), 1, 24, 16)
    _close(dispatch_to_2d(got, _t(feat)), jax.jit(j_dispatch)(ref, feat))


# -------------------------------------------------------- group attention
def test_query_group_self_attention():
    rng = np.random.default_rng(5)
    q, val = _rand(rng, 1, 6 * 4, 32), _rand(rng, 1, 6 * 4, 32)
    valid = rng.uniform(size=(1, 24)) < 0.6
    valid[0, 8:12] = False  # a camera with no valid slot
    sa = QueryGroupSelfAttention(32, 4, 6)
    jsa = JQGSA(embed_dims=32, num_heads=4, num_cams=6)
    v = pair(jsa, sa, jnp.asarray(q), jnp.asarray(val), jnp.asarray(valid))
    _close(sa(_t(q), _t(val), _t(valid)),
           japply(jsa, v, q, val, valid, deterministic=True))


SHAPES_FIT = ((16, 24), (8, 12), (8, 8), (8, 10))


@pytest.mark.parametrize("shapes,cap", [
    (SHAPES_FIT, 3), (((8, 16), (4, 8), (2, 4), (1, 2)), None),
])
def test_query_group_msda_serving_path(shapes, cap):
    """Patch mode with top-2 level selection (or its per-level fallback),
    slot compaction, and the value projection applied after sampling
    with the (wsum - 1) * bias correction, as the JAX serving head runs
    it (a shared pair table turns that path on in JAX)."""
    rng = np.random.default_rng(6)
    k = 5
    ss_j, ss_t = JSS(shapes), SpatialShapes(shapes)
    q, qpos = _rand(rng, 1, 6 * k, 16), _rand(rng, 1, 6 * k, 16)
    ref_pts = rng.uniform(0.05, 0.95, (1, 6 * k, 2)).astype(np.float32)
    depth = (rng.uniform(size=(1, 6 * k, 1)) < 0.7) * rng.uniform(
        1, 30, (1, 6 * k, 1))
    depth = depth.astype(np.float32)
    col = _rand(rng, 1, 6, ss_j.total, 16)
    msda = QueryGroupMSDA(16, 4, 4, 4, 6, gather_capacity=cap, sel_levels=2)
    jmsda = JMSDA(embed_dims=16, num_heads=4, num_levels=4, num_cams=6,
                  patch_mode=True, gather_capacity=cap, sel_levels=2)
    pt = make_pair_table(jnp.asarray(col).reshape(-1, 16))
    v = pair(jmsda, msda, jnp.asarray(q), jnp.asarray(qpos),
             jnp.asarray(ref_pts), jnp.asarray(depth), jnp.asarray(col),
             ss_j, pair_table=pt)
    ref = jax.jit(lambda v_, *a: jmsda.apply(
        v_, *a, ss_j, deterministic=True, pair_table=make_pair_table(
            a[-1].reshape(-1, 16))))(v, q, qpos, ref_pts, depth, col)
    got = msda(_t(q), _t(qpos), _t(ref_pts), _t(depth), _t(col), ss_t)
    _close(got, ref, atol=1e-4)


def test_dfa():
    rng = np.random.default_rng(7)
    shapes = ((8, 16), (4, 8), (2, 4), (1, 2))
    a = synthetic_anchors(20, 2)[None]
    feat, emb = _rand(rng, 1, 20, 16), _rand(rng, 1, 20, 16)
    col = _rand(rng, 1, 6, JSS(shapes).total, 16)
    proj = synthetic_rig(1, (64, 32))
    wh = np.full((1, 6, 2), (64.0, 32.0), np.float32)
    dfa = DeformableFeatureAggregation(16, 4, 4, 6, 6, gather_capacity=30)
    jdfa = JDFA(embed_dims=16, num_groups=4, num_levels=4, num_cams=6,
                gather_capacity=30)
    args = (feat, a, emb, col)
    v = pair(jdfa, dfa, *map(jnp.asarray, args), JSS(shapes),
             jnp.asarray(proj), jnp.asarray(wh))
    ref = jax.jit(lambda v_, f, an, e, c, p, w: jdfa.apply(
        v_, f, an, e, c, JSS(shapes), p, w, deterministic=True,
        pair_table=make_pair_table(c.reshape(-1, 16))))(
        v, feat, a, emb, col, proj, wh)
    got = dfa(_t(feat), _t(a), _t(emb), _t(col), SpatialShapes(shapes),
              _t(proj), _t(wh))
    _close(got, ref, atol=1e-4)


# ----------------------------------------------------------- instance bank
def _jstate(rng, bs, t, a, c):
    return JState(
        feature=jnp.asarray(_rand(rng, bs, t, c)),
        anchor=jnp.asarray(_anchor(t, 3).repeat(bs, 0)),
        confidence=jnp.asarray(rng.uniform(size=(bs, t)).astype(np.float32)),
        instance_id=jnp.asarray(
            np.where(rng.uniform(size=(bs, a)) < 0.5,
                     rng.integers(0, 50, (bs, a)), -1).astype(np.int32)),
        prev_id=jnp.asarray(np.array([50, 60], np.int32)),
    )


def _tstate(js):
    return TemporalState(**{f.name: _t(getattr(js, f.name))
                            for f in dataclasses.fields(TemporalState)})


def test_instance_bank_transitions():
    """get (the second sample's dt exceeds max_time_interval, which
    resets its stream), update, cache and id assignment."""
    rng = np.random.default_rng(8)
    bs, a, t, c = 2, 12, 5, 8
    kw = dict(num_anchor=a, num_temp_instances=t, embed_dims=c)
    jb, tb = JBank(**kw), InstanceBank(**kw)
    js = _jstate(rng, bs, t, a, c)
    ts = _tstate(js)
    anchor_p, feat_p = _anchor(a, 4)[0], _rand(rng, a, c)
    dt = np.array([0.5, 3.0], np.float32)
    t2c = np.tile(np.eye(4, dtype=np.float32), (bs, 1, 1))
    t2c[:, :3, 3] = [1.0, 0.5, 0.0]
    jg = jax.jit(lambda *a: jb.get(a[0], a[1], bs, *a[2:]))(
        anchor_p, feat_p, js, dt, t2c)
    tg = tb.get(_t(anchor_p), _t(feat_p), bs, ts, _t(dt), _t(t2c))
    for g, r in zip(tg, jg):
        _close(g, r, atol=1e-4)
    np.testing.assert_array_equal(tg[5].numpy(), [True, False])
    np.testing.assert_allclose(tg[4].numpy(), [0.5, 0.5])  # reset -> default

    inst, anch = _rand(rng, bs, a, c), _anchor(a, 5).repeat(bs, 0)
    logits = _rand(rng, bs, a, 10)
    ju = jax.jit(jb.update)(inst, anch, logits, jg[2], jg[3], jg[5])
    tu = tb.update(_t(inst), _t(anch), _t(logits), tg[2], tg[3], tg[5])
    for g, r in zip(tu, ju):
        _close(g, r, atol=1e-4)

    jc, jconf = jax.jit(jb.cache)(inst, anch, logits, js, jg[5])
    tc, tconf = tb.cache(_t(inst), _t(anch), _t(logits), ts, tg[5])
    _close(tconf, jconf)
    for name in ("feature", "anchor", "confidence"):
        _close(getattr(tc, name), getattr(jc, name), atol=1e-4, msg=name)
    jid, jst = jax.jit(lambda *a: jb.assign_instance_ids(
        *a, threshold=0.3, temp_mask=jg[5]))(logits, jc, jconf)
    tid, tst = tb.assign_instance_ids(_t(logits), tc, tconf,
                                      threshold=0.3, temp_mask=tg[5])
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tst.instance_id.numpy(),
                                  np.asarray(jst.instance_id))
    np.testing.assert_array_equal(tst.prev_id.numpy(),
                                  np.asarray(jst.prev_id))


def test_cold_start_ties_keep_lower_index():
    """At a cold start every cached confidence is 0: the top-k keeps the
    lower index first, as jax.lax.top_k does."""
    conf = np.zeros((2, 9), np.float32)
    conf[1, 4] = 0.5
    x = np.arange(18, dtype=np.float32).reshape(2, 9, 1)
    _, (jg,) = j_topk_gather(jnp.asarray(conf), 4, jnp.asarray(x))
    _, (tg,) = topk_gather(_t(conf), 4, _t(x))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tg[0, :, 0].numpy(), [0, 1, 2, 3])
