"""The exact-sampling serving path of the port against the JAX package, on
the CPU: exact MSDA (`msda_plain`, and the `msda` wrapper, its planner
and refusals), `msda_window_stats`, the guard counters of the 2D
cross-attention and DFA layers, and the whole tiny slice under
`simpb_tiny` with exact MSDA, `guard_sampling` and capacities that bite.

Inputs come from numpy seeds; the JAX side is jitted. Tolerances: exact
MSDA in fp32 within 1e-5 of the output's range (the fp32 sums run in
another order), in bf16 within 1e-2 of it (XLA's bf16 elementwise
fusions may keep excess precision where the port rounds); the layers as
tests/test_torch_port_blocks.py holds them (1e-4 where matmuls chain);
the slice as tests/test_torch_port_slice.py holds it (5e-4 / 1e-3), its
guard maxima equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs.base import simpb_tiny as jax_tiny
from simpb_tpu.models.decoder3d import decode_boxes3d as jax_decode
from simpb_tpu.models.detector import SimPB as JaxSimPB
from simpb_tpu.models.dfa import DeformableFeatureAggregation as JDFA
from simpb_tpu.models.group_attn import QueryGroupMSDA as JMSDA
from simpb_tpu.ops import sampling as jsmp
from simpb_tpu.ops.format import SpatialShapes as JSS
from simpb_tpu.ops.sampling import make_pair_table
from simpb_tpu.utils.guards import summarize_guards as jax_summarize
from simpb_tpu.utils.synthetic import synthetic_anchors, synthetic_rig
from simpb_tpu_torch.configs.base import simpb_tiny
from simpb_tpu_torch.models.decoder3d import decode_boxes3d
from simpb_tpu_torch.models.detector import SimPB
from simpb_tpu_torch.models.dfa import DeformableFeatureAggregation
from simpb_tpu_torch.models.group_attn import QueryGroupMSDA
from simpb_tpu_torch.models.instance_bank import TemporalState
from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.ops.format import SpatialShapes
from simpb_tpu_torch.training.evaluate import make_stream_steps
from simpb_tpu_torch.utils import guards as tguards
from simpb_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_blocks import _rand, _t, pair
from test_torch_port_slice import _temp2cur, random_jax_variables

torch.set_num_threads(1)
TINY_SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))  # simpb_tiny's pyramid
SHAPES_FIT = ((16, 24), (8, 12), (8, 8), (8, 10))  # 8x8 fits every level
SLICE_ATOL, SLICE_RTOL = 5e-4, 1e-3


def _msda_inputs(rng, b=2, q=6, heads=4, points=4, c=16,
                 shapes=TINY_SHAPES):
    """Values, locations [b, q, heads, L, P, 2] and softmax weights:
    query 0 at the borders (0 and 1 exactly, and one ulp inside), query
    1 past every border, query 2 a padded slot (location 0), the rest
    spread over and beyond the image."""
    levels = len(shapes)
    total = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, total, c)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, q, heads, levels, points, 2))
    edges = np.array([0.0, 1.0, 2.0 ** -10, 1 - 2.0 ** -10])
    loc[:, 0] = rng.choice(edges, loc[:, 0].shape)
    loc[:, 1] = rng.choice(np.array([-2.0, -0.6, 1.6, 3.0]), loc[:, 1].shape)
    loc[:, 2] = 0.0
    logits = rng.normal(size=(b, q, heads, levels * points))
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (value, loc.astype(np.float32),
            attw.reshape(b, q, heads, levels, points).astype(np.float32))


@pytest.mark.parametrize("raw", [True, False], ids=["raw_heads", "heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_plain_matches_jax(dtype, raw):
    """(a) `msda_plain` against JAX's `msda` at the tiny pyramid (its 8x22
    twin, the 1x2 level, holds the left-border pair swap's case at every
    level), samples past every border and padded slots."""
    value, loc, attw = _msda_inputs(np.random.default_rng(0))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax.jit(lambda v, l, a: jsmp.msda(
        v, JSS(TINY_SHAPES), l, a, raw_heads=raw))(
        jnp.asarray(value).astype(jdt), loc, attw)
    got = tsmp.msda_plain(_t(value).to(getattr(torch, dtype)),
                          SpatialShapes(TINY_SHAPES), _t(loc), _t(attw),
                          raw_heads=raw)
    got = got if raw else (got,)
    want = want if raw else (want,)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), w, atol=tol * scale, rtol=0)
    if raw:  # a padded slot samples pixel (0, 0) with a quarter weight
        np.testing.assert_allclose(got[1][:, 2].numpy(), 0.25, atol=1e-6)


def test_msda_wrapper_on_cpu():
    """On CPU tensors the wrapper is its plain version bit for bit, also
    under autograd, and launches nothing; it refuses what the kernel
    does not take."""
    value, loc, attw = map(_t, _msda_inputs(np.random.default_rng(1)))
    ss = SpatialShapes(TINY_SHAPES)
    tsmp.reset_launch_counts()
    for raw in (True, False):
        got = tsmp.msda(value, ss, loc, attw, raw_heads=raw)
        ref = tsmp.msda_plain(value, ss, loc, attw, raw_heads=raw)
        for g, r in zip(got if raw else (got,), ref if raw else (ref,)):
            assert torch.equal(g, r)
    loc.requires_grad_(True)
    got = torch.autograd.grad(tsmp.msda(value, ss, loc, attw).sum(), loc)[0]
    ref = torch.autograd.grad(tsmp.msda_plain(value, ss, loc, attw).sum(),
                              loc)[0]
    assert torch.equal(got, ref) and got.abs().max() > 0
    assert set(tsmp.launch_counts().values()) == {0}
    loc = loc.detach()
    with pytest.raises(TypeError, match="float32"):
        tsmp.msda(value, ss, loc.double(), attw)
    with pytest.raises(ValueError, match="contiguous"):
        tsmp.msda(value, ss, loc.transpose(1, 2), attw)
    with pytest.raises(ValueError, match="do not fit"):
        tsmp.msda(value, ss, loc, attw[:, :, :, :3].contiguous())
    with pytest.raises(ValueError, match="cover"):
        tsmp.msda(value[:, 1:].contiguous(), ss, loc, attw)


@pytest.mark.parametrize("heads,c,levels,ok", [
    (8, 256, 4, True), (4, 64, 4, True), (9, 288, 4, False),
    (8, 260, 4, False), (8, 256, 9, False)],
    ids=["r50", "tiny", "heads9", "c260", "levels9"])
def test_msda_planner(heads, c, levels, ok):
    """The kernel's launch at the configs' widths; more than 8 heads, C
    not a multiple of 8 and more than MAX_LEVELS levels are refused."""
    shapes = ((64, 176), (32, 88), (16, 44), (8, 22), (4, 11), (2, 6),
              (1, 3), (1, 2), (1, 1))[:levels]
    if not ok:
        with pytest.raises(ValueError, match="msda"):
            tsmp.plan_msda(6, 256, heads, 4, c, shapes)
        return
    plan = tsmp.plan_msda(6, 256, heads, 4, c, shapes)
    assert plan.grid == (6 * 256, 1) and plan.threads == 32 * heads
    assert list(plan.dims)[:8] == [6, 256, heads, levels, 4, c,
                                   sum(h * w for h, w in shapes), 32 * heads]


@pytest.mark.parametrize("shapes,sel", [
    (SHAPES_FIT, None), (SHAPES_FIT, 2), (TINY_SHAPES, 2)],
    ids=["all_levels", "top2", "top2_falls_back"])
def test_msda_window_stats_match_jax(shapes, sel):
    """(b) The window guard against JAX's, with a valid mask; the spread
    of the samples reaches past the 8x8 windows."""
    rng = np.random.default_rng(2)
    b, q, heads, levels, points = 2, 7, 4, 4, 4
    ref = rng.uniform(0.1, 0.9, (b, q, 1, 1, 1, 2))
    loc = (ref + 0.3 * rng.normal(size=(b, q, heads, levels, points, 2))
           ).astype(np.float32)
    attw = rng.uniform(size=(b, q, heads, levels, points)).astype(np.float32)
    attw /= attw.sum((2, 3, 4), keepdims=True)
    valid = rng.uniform(size=(b, q)) < 0.7
    want = jax.jit(lambda l, a, v: jsmp.msda_window_stats(
        JSS(shapes), l, a, 8, 8, sel_levels=sel, valid=v))(loc, attw, valid)
    got = tsmp.msda_window_stats(SpatialShapes(shapes), _t(loc), _t(attw),
                                 8, 8, sel_levels=sel, valid=_t(valid))
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["window_clamped"].numpy(),
                                  np.asarray(want["window_clamped"]))
    assert got["window_clamped"].min() > 0
    for k in ("window_clamped_mass", "level_dropped_mass"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
    if sel is not None and shapes is SHAPES_FIT:
        assert got["level_dropped_mass"].min() > 0


@pytest.mark.parametrize("cap", [None, 3], ids=["no_cap", "cap_bites"])
def test_query_group_msda_exact(cap):
    """(c) The exact 2D cross-attention against JAX's
    `QueryGroupMSDA(patch_mode=False)` in post-projection mode (a pair
    table given), with the guard on: with the cap below a camera's valid
    slot count the compaction runs and `msda_overflow` is nonzero and
    JAX's sown value."""
    rng = np.random.default_rng(6)
    k = 5
    ss_j, ss_t = JSS(TINY_SHAPES), SpatialShapes(TINY_SHAPES)
    q, qpos = _rand(rng, 1, 6 * k, 16), _rand(rng, 1, 6 * k, 16)
    ref_pts = rng.uniform(0.05, 0.95, (1, 6 * k, 2)).astype(np.float32)
    depth = (rng.uniform(size=(1, 6 * k, 1)) < 0.8) * rng.uniform(
        1, 30, (1, 6 * k, 1))
    depth[0, :k] = 5.0  # camera 0: all five slots valid
    depth = depth.astype(np.float32)
    col = _rand(rng, 1, 6, ss_j.total, 16)
    msda = QueryGroupMSDA(16, 4, 4, 4, 6, gather_capacity=cap,
                          patch_mode=False)
    jmsda = JMSDA(embed_dims=16, num_heads=4, num_levels=4, num_cams=6,
                  patch_mode=False, gather_capacity=cap, guard=True)
    pt = make_pair_table(jnp.asarray(col).reshape(-1, 16))
    v = pair(jmsda, msda, jnp.asarray(q), jnp.asarray(qpos),
             jnp.asarray(ref_pts), jnp.asarray(depth), jnp.asarray(col),
             ss_j, pair_table=pt)
    ref, mut = jax.jit(lambda v_, *a: jmsda.apply(
        v_, *a, ss_j, deterministic=True, mutable=["guards"],
        pair_table=make_pair_table(a[-1].reshape(-1, 16))))(
        v, q, qpos, ref_pts, depth, col)
    guards = {}
    with torch.no_grad():  # serving: the exact backward is not ported
        got = msda(_t(q), _t(qpos), _t(ref_pts), _t(depth), _t(col), ss_t,
                   guards=guards)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    want = float(mut["guards"]["msda_overflow"][0])
    assert list(guards) == ["msda_overflow"]
    assert float(guards["msda_overflow"][0]) == want
    assert (want > 0) == (cap is not None)


def test_dfa_overflow_matches_jax():
    """(d) DFA's `dfa_overflow` at a capacity that bites, against JAX's
    sown value, and the layer's output with it."""
    rng = np.random.default_rng(7)
    shapes = TINY_SHAPES
    a = synthetic_anchors(20, 2)[None]
    feat, emb = _rand(rng, 1, 20, 16), _rand(rng, 1, 20, 16)
    col = _rand(rng, 1, 6, JSS(shapes).total, 16)
    proj = synthetic_rig(1, (64, 32))
    wh = np.full((1, 6, 2), (64.0, 32.0), np.float32)
    dfa = DeformableFeatureAggregation(16, 4, 4, 6, 6, gather_capacity=12)
    jdfa = JDFA(embed_dims=16, num_groups=4, num_levels=4, num_cams=6,
                gather_capacity=12, guard=True)
    args = (feat, a, emb, col)
    v = pair(jdfa, dfa, *map(jnp.asarray, args), JSS(shapes),
             jnp.asarray(proj), jnp.asarray(wh))
    ref, mut = jax.jit(lambda v_, f, an, e, c, p, w: jdfa.apply(
        v_, f, an, e, c, JSS(shapes), p, w, deterministic=True,
        mutable=["guards"], pair_table=make_pair_table(c.reshape(-1, 16))))(
        v, feat, a, emb, col, proj, wh)
    guards = {}
    got = dfa(_t(feat), _t(a), _t(emb), _t(col), SpatialShapes(shapes),
              _t(proj), _t(wh), guards=guards)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    want = float(mut["guards"]["dfa_overflow"][0])
    assert want > 0
    assert float(guards["dfa_overflow"][0]) == want


def test_guards_helpers_match_jax():
    """`summarize_guards` (nested or flat, several values a name),
    `merge_guard_maxima` and `check_guard_violations` as JAX's."""
    from simpb_tpu.utils import guards as jg

    tree = {"a": {"msda_overflow": (np.float32(0.0), np.float32(2.0))},
            "b": {"msda_overflow": (np.float32(1.0),),
                  "dfa_overflow": (np.zeros(3, np.float32),)}}
    want = {k: float(v) for k, v in jg.summarize_guards(tree).items()}
    got = tguards.summarize_guards({
        "msda_overflow": [torch.tensor(0.0), torch.tensor(2.0),
                          torch.tensor(1.0)],
        "dfa_overflow": [torch.zeros(3)]})
    assert {k: float(v) for k, v in got.items()} == want
    assert {k: float(v) for k, v in tguards.summarize_guards(tree).items()} \
        == want
    a, b = {"guard_x": 1.0}, {"guard_x": 0.5, "guard_y": 2.0}
    assert tguards.merge_guard_maxima(a, b) == jg.merge_guard_maxima(a, b)
    metrics = {"guard_dfa_overflow": 3.0, "guard_msda_overflow": 0.0,
               "guard_msda_clamp_demand": 9.0, "guard_nan": float("nan"),
               "mAP": 0.5}
    assert tguards.check_guard_violations(metrics) == \
        jg.check_guard_violations(metrics) == ["guard_dfa_overflow"]


def _guarded_exact(cfg, fused):
    """Exact MSDA, guard counters on, and capacities that bite: four of
    the eight 2D slots a camera, 96 of the 416 DFA slots."""
    head = dataclasses.replace(cfg.head, guard_sampling=True,
                               msda_gather_capacity=4,
                               dfa_gather_capacity=96)
    return dataclasses.replace(cfg, head=head, backbone_fused_infer=fused)


@pytest.fixture(scope="module")
def exact_run():
    """The guarded exact tiny slice through JAX (module trunk, as in
    tests/test_torch_port_slice.py) and the port (fused trunk): one cold
    frame and two stream frames, both taking JAX's incoming state each
    frame. Returns (jcfg, JAX outputs, JAX guard maxima, port outputs,
    port guard maxima, the port's cold-step decode)."""
    jcfg = _guarded_exact(jax_tiny(), fused=False)
    tcfg = _guarded_exact(simpb_tiny(), fused=True)
    bs, w, h = 1, 64, 32
    rng = np.random.default_rng(3)
    imgs = rng.normal(size=(3, bs, 6, h, w, 3)).astype(np.float32)
    proj = synthetic_rig(bs, (w, h))
    dts = [np.full((bs,), 0.5, np.float32), np.full((bs,), 0.4, np.float32)]
    t2cs = [_temp2cur(0.05, 0.8, -0.3), _temp2cur(-0.02, 0.5, 0.1)]
    jmodel = JaxSimPB(jcfg)
    variables = random_jax_variables(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(imgs[0]),
                            jnp.asarray(proj), train=False)))
    tmodel = SimPB(tcfg)
    tmodel.load_state_dict(from_jax_variables(variables, tcfg), strict=True)
    tmodel.eval()

    def japply(v, img, p, **kw):
        out, mut = jmodel.apply(v, img, p, train=False, mutable=["guards"],
                                **kw)
        return out, jax_summarize(mut["guards"])

    opts = {"xla_backend_optimization_level": 1}
    cold = jax.jit(japply)
    stream = jax.jit(lambda v, img, p, s, dt, t2c: japply(
        v, img, p, temporal=s, time_interval=dt, temp2cur=t2c))
    jouts, jguards, touts, tguard = [], [], [], []
    jstate = None
    for f in range(3):
        tkw = {}
        if f:
            args = (variables, jnp.asarray(imgs[f]), jnp.asarray(proj),
                    jstate, jnp.asarray(dts[f - 1]),
                    jnp.asarray(t2cs[f - 1]))
            if f == 1:
                stream = stream.lower(*args).compile(opts)
            jo, jg = stream(*args)
            tkw = dict(
                temporal=TemporalState(**{
                    k: torch.from_numpy(np.array(getattr(jstate, k)))
                    for k in ("feature", "anchor", "confidence",
                              "instance_id", "prev_id")}),
                time_interval=torch.from_numpy(dts[f - 1]),
                temp2cur=torch.from_numpy(t2cs[f - 1]))
        else:
            args = (variables, jnp.asarray(imgs[0]), jnp.asarray(proj))
            cold = cold.lower(*args).compile(opts)
            jo, jg = cold(*args)
        jouts.append(jax.tree_util.tree_map(np.asarray, jo))
        jguards.append({k: float(v) for k, v in jg.items()})
        with torch.inference_mode():
            to = tmodel(torch.from_numpy(imgs[f]), torch.from_numpy(proj),
                        **tkw)
        touts.append(to)
        tguard.append({k: float(v) for k, v in
                       tguards.summarize_guards(to["guards"]).items()})
        jstate = jo["temporal_state"]
    cold_dec, _ = make_stream_steps(tmodel, tcfg)[0](
        torch.from_numpy(imgs[0]), torch.from_numpy(proj))
    return jcfg, jouts, jguards, touts, tguard, cold_dec


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_exact_slice_matches_jax(exact_run, frame):
    """(e) Head outputs within the slice tolerance, allocations, decode
    and instance ids equal, and every guard maximum equal to JAX's, the
    capacity overflows nonzero."""
    jcfg, jouts, jguards, touts, tguard, _ = exact_run
    jo, to = jouts[frame], touts[frame]
    close = lambda t, j, msg: np.testing.assert_allclose(
        t.detach().float().numpy(), np.asarray(j), atol=SLICE_ATOL,
        rtol=SLICE_RTOL, err_msg=msg)
    for key in ("prediction", "classification", "quality", "prediction2d",
                "classification2d", "prediction_alpha2d"):
        assert len(jo[key]) == len(to[key]), key
        for lyr, (j, t) in enumerate(zip(jo[key], to[key])):
            assert (j is None) == (t is None), f"{key} {lyr}"
            if t is not None:
                close(t, j, f"frame {frame} {key} layer {lyr}")
    for a_j, a_t in zip(jo["allocations"], to["allocations"]):
        np.testing.assert_array_equal(a_t.valid.numpy(), np.asarray(a_j.valid))
    np.testing.assert_array_equal(to["instance_id"].numpy(),
                                  np.asarray(jo["instance_id"]))
    kw = dict(num_output=jcfg.head.num_output,
              score_threshold=jcfg.head.score_threshold)
    jd = jax_decode(jnp.asarray(jo["classification"][-1]),
                    jnp.asarray(jo["prediction"][-1]),
                    instance_id=jnp.asarray(jo["instance_id"]),
                    quality=jnp.asarray(jo["quality"][-1]), **kw)
    td = decode_boxes3d(to["classification"][-1], to["prediction"][-1],
                        instance_id=to["instance_id"],
                        quality=to["quality"][-1], **kw)
    for key in ("anchor_idx", "labels_3d", "valid", "instance_ids"):
        np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    close(td["boxes_3d"], jd["boxes_3d"], f"frame {frame} boxes_3d")
    assert tguard[frame] == jguards[frame]
    assert sorted(tguard[frame]) == ["dfa_overflow", "msda_overflow"]
    assert min(tguard[frame].values()) > 0


def test_exact_stream_step_attaches_guards(exact_run):
    """`make_stream_steps` puts each guard maximum into the decode as a
    [bs] `guard_*` entry, left on the model's device."""
    _, _, jguards, _, _, dec = exact_run
    got = {k[len("guard_"):]: v for k, v in dec.items()
           if k.startswith("guard_")}
    assert {k: float(v[0]) for k, v in got.items()} == jguards[0]
    assert all(tuple(v.shape) == (1,) for v in got.values())


def test_training_an_exact_config_is_refused():
    """Exact MSDA has its backward (kernel D, ROADMAP B.1 done), so an
    exact config trains: the training model of `simpb_tiny` builds, and
    one training step on the CPU gives a finite loss and nonzero
    gradients to every input of each of its three exact MSDA calls; the
    exact layer takes the training order (`project_first`)."""
    from simpb_tpu_torch.configs.base import TrainConfig
    from simpb_tpu_torch.training.train_step import (
        build_train_model, build_train_step, create_train_state,
        init_temporal,
    )
    from simpb_tpu_torch.utils.synthetic import (
        batch_to_torch, synthetic_train_batch,
    )

    cfg = simpb_tiny()
    assert not cfg.head.msda_patch_mode
    SimPB(cfg, train=True)
    model = build_train_model(cfg, device="cpu")
    tc = TrainConfig()
    state = create_train_state(model, tc)
    batch = batch_to_torch(synthetic_train_batch(
        cfg, 1, num_objects=8, max_gt3d=8, max_gt2d=6), "cpu")
    temporal, dn_state = init_temporal(cfg, 1, "cpu")
    inputs = []
    plain = tsmp.msda_plain

    def record(value, ss, loc, attw, raw_heads=False):
        for t in (value, loc, attw):
            t.retain_grad()
        inputs.append((value, loc, attw))
        return plain(value, ss, loc, attw, raw_heads)

    step = build_train_step(model, tc)
    tsmp.msda_plain = record
    try:
        _, _, _, m = step(state, batch, temporal, dn_state, 0)
    finally:
        tsmp.msda_plain = plain
    assert torch.isfinite(m["loss"]) and len(inputs) == 3
    for value, loc, attw in inputs:
        assert all(t.grad is not None and t.grad.abs().max() > 0
                   for t in (value, loc, attw))
    layer = QueryGroupMSDA(16, 4, 4, 4, 6, patch_mode=False)
    out = layer(torch.zeros(1, 6, 16), None, torch.full((1, 6, 2), 0.5),
                torch.ones(1, 6, 1), torch.randn(1, 6, 170, 16),
                SpatialShapes(TINY_SHAPES), project_first=True)
    assert tuple(out.shape) == (1, 6, 32)
