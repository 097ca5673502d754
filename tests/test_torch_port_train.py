"""The port's training pieces against the JAX package, one function at a
time: the assignment (kernel A's plain version), the gradients of the
two sampling ops (kernels B and C's plain versions: autograd through
the forwards' plain versions), the losses, the 3D / 2D targets, the DN
anchors and cache, the grid mask, `total_loss` on one fixed outputs
dict, and the optimizer and its schedule.

Inputs come from numpy seeds and go to both packages; random draws
are made by JAX and fed to the port's deterministic cores. Tolerances:
the assignment exactly (`col4row`) and against scipy's optimal cost at
1e-5 relative; fp32 gradients at 1e-5 of each gradient's largest value;
bf16 gradients at 1e-2 of each gradient's range (max - min): JAX's bf16
autodiff rounds each level's contribution to a point's gradient to bf16
before the four levels add (one bf16 step is 1/128 to 1/256 of the
value), the port sums them in fp32 and rounds once, so the two differ by
a few bf16 steps of the largest value; losses, targets, DN and the
grid mask at 1e-6 relative (fp32, a handful of operations); the loss
dict at 1e-5 relative; one optimizer update at 1e-6 relative.
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.optimize
import torch

from simpb_tpu.configs.base import TrainConfig as JTrainConfig
from simpb_tpu.models import grid_mask as jgm
from simpb_tpu.ops import format as jfmt
from simpb_tpu.ops import sampling as jsmp
from simpb_tpu.training import dn as jdn
from simpb_tpu.training import loss_head as jlh
from simpb_tpu.training import losses as jl
from simpb_tpu.training import matching as jmatch
from simpb_tpu.training import targets2d as jt2
from simpb_tpu.training import targets3d as jt3
from simpb_tpu.training import train_step as jts
from simpb_tpu_torch.configs.base import TrainConfig
from simpb_tpu_torch.models import grid_mask as tgm
from simpb_tpu_torch.ops import format as tfmt
from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.training import dn as tdn
from simpb_tpu_torch.training import loss_head as tlh
from simpb_tpu_torch.training import losses as tl
from simpb_tpu_torch.training import matching as tmatch
from simpb_tpu_torch.training import targets2d as tt2
from simpb_tpu_torch.training import targets3d as tt3
from simpb_tpu_torch.training import train_step as tts
from simpb_tpu_torch.utils.synthetic import (
    dn_bundle_from_numpy, dn_state_from_numpy,
)

torch.set_num_threads(1)
RTOL = 1e-6
SHAPES_FIT = ((16, 24), (8, 12), (8, 8), (8, 10))  # 8x8 fits every level
SHAPES_TINY = ((8, 16), (4, 8), (2, 4), (1, 2))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, rtol=RTOL, atol=1e-7, msg=""):
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jit(fn, *args, **static):
    return jax.jit(functools.partial(fn, **static))(*args)


def _scaled_close(t, j, frac, msg="", span=False):
    """|t - j| <= frac * max|j| elementwise (span: frac * (max j - min j),
    the range)."""
    t, j = _np(t), _np(j)
    scale = j.max() - j.min() if span else np.abs(j).max()
    bound = frac * max(scale, 1e-30)
    err = np.abs(t - j).max()
    assert err <= bound, f"{msg}: max err {err} > {bound}"


# ----------------------------------------------------------- assignment
def _lsa_cases():
    rng = np.random.default_rng(0)
    rand = rng.uniform(0, 10, (3, 6, 14)).astype(np.float32)
    valid = np.ones((3, 6), bool)
    padded = valid.copy()
    padded[:, 4:] = False
    padded[1, 0] = False
    ties = rng.integers(0, 3, (4, 7, 9)).astype(np.float32)
    naninf = rng.uniform(-5, 5, (2, 5, 8)).astype(np.float32)
    naninf[0, 1, 2] = np.nan
    naninf[1, 3, 4] = np.inf
    naninf[1, 0, 0] = -np.inf
    return {
        "random": (rand, valid),
        "padded": (rand, padded),
        "square": (rng.normal(size=(2, 7, 7)).astype(np.float32),
                   np.ones((2, 7), bool)),
        "integer_ties": (ties, np.ones((4, 7), bool)),
        "nan_inf": (naninf, np.ones((2, 5), bool)),
    }


@pytest.mark.parametrize("case", list(_lsa_cases()))
def test_assignment_plain_matches_jax_and_scipy(case):
    cost, valid = _lsa_cases()[case]
    ref = np.asarray(jax.jit(lambda c, v: jmatch.batched_assignment(
        c, v, 1e6))(cost, valid))
    got = tmatch.batched_assignment(_t(cost), _t(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    safe = np.nan_to_num(np.where(valid[..., None], cost, 1e6), nan=1e6,
                         posinf=1e6, neginf=-1e6)
    for b in range(cost.shape[0]):
        rows = np.nonzero(valid[b])[0]
        col = got[b].numpy()
        assert len(set(col.tolist())) == len(col)  # distinct columns
        sub = safe[b][rows]
        r, c = scipy.optimize.linear_sum_assignment(sub)
        best = sub[r, c].sum()
        np.testing.assert_allclose(safe[b][rows, col[rows]].sum(), best,
                                   rtol=1e-5)


def test_assignment_refuses_what_it_does_not_take():
    cost = torch.zeros(1, 5, 3)
    with pytest.raises(ValueError, match="rows <= cols"):
        tmatch.batched_assignment(cost, torch.ones(1, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tmatch.batched_assignment(cost.transpose(1, 2).to("meta"),
                                  torch.ones(1, 3, dtype=torch.bool,
                                             device="meta"))
    assert tmatch.launch_counts() == {"assignment": 0}


# ------------------------------------------------ sampling-op gradients
def _grads_jax(fn, args, cot):
    def f(*a):
        out = fn(*a)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cot))
    return jax.jit(jax.grad(f, argnums=tuple(range(len(args)))))(*args)


def _grads_torch(fn, args, cot):
    args = [a.clone().requires_grad_(True) for a in args]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * _t(c)).sum() for o, c in zip(outs, cot))
    return torch.autograd.grad(loss, args)


@pytest.mark.parametrize("capacity,dtype", [
    (None, "float32"), (40, "float32"), (None, "bfloat16"),
    (60, "bfloat16"),
])
def test_dfa_gradients_match_jax(capacity, dtype):
    """Gradients to features, points and weights; points straddle the
    image border (whole samples dropped) and a capacity below the
    in-range count drops slots (their gradients are zero)."""
    rng = np.random.default_rng(4)
    bf16 = dtype == "bfloat16"
    shapes = SHAPES_FIT if bf16 else SHAPES_TINY
    anchors = 16 if bf16 else 8
    col = rng.normal(size=(1, 6, sum(h * w for h, w in shapes), 16))
    pts = rng.uniform(-0.3, 1.3, (1, anchors, 13, 6, 2))
    w = rng.uniform(size=(1, anchors, 13, 6, 4, 4))
    cot = (rng.normal(size=(1, anchors, 16)).astype(np.float32),)
    np_args = [a.astype(np.float32) for a in (col, pts, w)]
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jss, tss = jfmt.SpatialShapes(shapes), tfmt.SpatialShapes(shapes)
    ref = _grads_jax(lambda c, p, w_: jsmp.deformable_aggregation(
        c, jss, p, w_, gather_capacity=capacity),
        [jnp.asarray(a, jdt) for a in np_args], cot)
    got = _grads_torch(lambda c, p, w_: tsmp.deformable_aggregation(
        c, tss, p, w_, gather_capacity=capacity),
        [_t(a).to(tdt) for a in np_args], cot)
    for name, g, r in zip(("col", "points", "weights"), got, ref):
        assert g.dtype == tdt
        _scaled_close(g, r, 1e-2 if bf16 else 1e-5, name, span=bf16)
    if capacity is not None:  # dropped slots got no gradient
        full = _grads_torch(lambda c, p, w_: tsmp.deformable_aggregation(
            c, tss, p, w_), [_t(a).to(tdt) for a in np_args], cot)
        assert (full[2].float() - got[2].float()).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_sel_gradients_match_jax(dtype):
    """`_msda_patch_sel` (top-2 levels, 8x8 windows): gradients of
    (sampled, wsum) to value, locations and weights; samples spread past
    the window (the taper clamp) and off the image border."""
    rng = np.random.default_rng(5)
    bf16 = dtype == "bfloat16"
    ss = jfmt.SpatialShapes(SHAPES_FIT)
    value = rng.normal(size=(3, ss.total, 16)).astype(np.float32)
    ref_pts = rng.uniform(0.0, 1.0, (3, 5, 1, 1, 1, 2))
    loc = (ref_pts + rng.normal(size=(3, 5, 4, 4, 4, 2)) * 0.2).astype(
        np.float32)
    attw = rng.uniform(size=(3, 5, 4, 4, 4)).astype(np.float32)
    attw /= attw.sum((-1, -2), keepdims=True)
    cot = (rng.normal(size=(3, 5, 4, 16)).astype(np.float32),
           rng.normal(size=(3, 5, 4)).astype(np.float32))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    ref = _grads_jax(lambda v, l, a: jsmp.msda_patch(
        v, ss, l, a, sel_levels=2, raw_heads=True),
        [jnp.asarray(value, jdt), loc, attw], cot)
    tss = tfmt.SpatialShapes(SHAPES_FIT)
    got = _grads_torch(lambda v, l, a: tsmp.msda_patch(
        v, tss, l, a, sel_levels=2, raw_heads=True),
        [_t(value).to(tdt), _t(loc), _t(attw)], cot)
    for name, g, r in zip(("value", "loc", "attw"), got, ref):
        _scaled_close(g, r, 1e-2 if bf16 else 1e-5, name, span=bf16)
    assert (got[1] == 0).any() and (got[1] != 0).any()


def test_backward_wrappers_refuse_cpu_tensors():
    col = torch.zeros(1, 6, 4, 16)
    ss = tfmt.SpatialShapes(((2, 2),))
    pts = torch.zeros(1, 2, 13, 6, 2)
    w = torch.zeros(1, 2, 13, 6, 1, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsmp.deformable_aggregation_backward(col, ss, pts, w,
                                             torch.zeros(1, 2, 16))
    value = torch.zeros(2, 16 * 16, 16)
    ss = tfmt.SpatialShapes(((16, 16),))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsmp.msda_patch_sel_backward(
            value, ss, torch.zeros(2, 3, 1, 8, 2), torch.zeros(2, 3, 1, 8),
            2, 8, 8, 1, torch.zeros(2, 3, 2, 16), torch.zeros(2, 3, 2))


def test_planted_faults_each_edit_one_scatter():
    """Each planted fault of the tool finds each line it edits once in
    the kernel source (a backward's scatter, the exact MSDA forward's
    sample, or a line of each of H1's two kernels, H2 or H3), and each
    edit keeps the line's indentation."""
    from simpb_tpu_torch.tools import planted_faults as pf

    src = (pf.ROOT / "simpb_tpu_torch" / "csrc" / "sampling.cu").read_text()
    kernels = {n for n, *_ in tsmp.BACKWARD_KERNELS + tsmp.KERNELS}
    for fault, (kernel, olds, news) in pf.FAULTS.items():
        if kernel is None:
            continue
        assert kernel in kernels, fault
        for old, new in pf.edits(olds, news):
            assert src.count(old) == 1, fault
            assert new != old and new.startswith(old[:len(old) - len(
                old.lstrip())] + "if ("), fault


# --------------------------------------------------------------- losses
def test_losses_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(20, 10)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, 20).astype(np.int32)
    weight = rng.uniform(size=20).astype(np.float32)
    avg = np.float32(7.0)
    _close(tl.sigmoid_focal_loss(_t(logits), _t(labels), _t(weight),
                                 _t(avg), loss_weight=2.0),
           _jit(jl.sigmoid_focal_loss, logits, labels, weight, avg,
                loss_weight=2.0))
    cls = rng.normal(size=(2, 12, 10)).astype(np.float32)
    gl = rng.integers(0, 10, (2, 5)).astype(np.int32)
    _close(tl.focal_match_cost(_t(cls), _t(gl), 0.25, 2.0, 1e-12, 2.0),
           _jit(jl.focal_match_cost, cls, gl, alpha=0.25, gamma=2.0,
                eps=1e-12, weight=2.0))
    a, b = (rng.normal(size=(20, 4)).astype(np.float32) for _ in range(2))
    w4 = rng.uniform(size=(20, 4)).astype(np.float32)
    _close(tl.l1_loss(_t(a), _t(b), _t(w4), _t(avg)),
           _jit(jl.l1_loss, a, b, w4, avg))
    tgt = rng.uniform(size=(20, 4)).astype(np.float32)
    _close(tl.bce_loss(_t(a), _t(tgt), _t(w4), _t(avg)),
           _jit(jl.bce_loss, a, tgt, w4, avg))
    prob = rng.uniform(0.01, 0.99, (20,)).astype(np.float32)
    yt = (rng.uniform(size=20) > 0.5).astype(np.float32)
    _close(tl.gaussian_focal_loss(_t(prob), _t(yt), _t(weight), _t(avg)),
           _jit(jl.gaussian_focal_loss, prob, yt, weight, avg))
    x1 = rng.uniform(0, 50, (20, 2))
    xyxy = lambda: np.concatenate(
        [x1, x1 + rng.uniform(1, 30, (20, 2))], -1).astype(np.float32)
    p_box, t_box = xyxy(), xyxy()
    _close(tl.giou(_t(p_box), _t(t_box)), _jit(jl.giou, p_box, t_box))
    _close(tl.giou_loss(_t(p_box), _t(t_box), _t(w4), _t(avg)),
           _jit(jl.giou_loss, p_box, t_box, w4, avg))
    cxcy = rng.uniform(0.1, 0.9, (20, 4)).astype(np.float32)
    _close(tl.bbox_cxcywh_to_xyxy(_t(cxcy)),
           _jit(jl.bbox_cxcywh_to_xyxy, cxcy))
    _close(tl.bbox_xyxy_to_cxcywh(_t(p_box)),
           _jit(jl.bbox_xyxy_to_cxcywh, p_box))


def test_sparse_box3d_loss_matches_jax():
    rng = np.random.default_rng(7)
    box = rng.normal(size=(30, 10)).astype(np.float32)
    tgt = rng.normal(size=(30, 10)).astype(np.float32)
    w = rng.uniform(size=(30, 10)).astype(np.float32)
    qt = rng.normal(size=(30, 2)).astype(np.float32)
    cls_t = rng.integers(0, 11, 30).astype(np.int32)
    qm = rng.uniform(size=30) > 0.3
    avg = np.float32(9.0)
    ref = _jit(lambda *a: jl.sparse_box3d_loss(*a, suffix="3d_0"), box, tgt,
               w, avg, qt, cls_t, qm)
    got = tl.sparse_box3d_loss(_t(box), _t(tgt), _t(w), _t(avg), _t(qt),
                               _t(cls_t), _t(qm), suffix="3d_0")
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], msg=k)


# -------------------------------------------------------------- targets
def _gt3d(rng, bs, g, n_valid):
    boxes = np.zeros((bs, g, 9), np.float32)
    boxes[..., :2] = rng.uniform(-30, 30, (bs, g, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (bs, g))
    boxes[..., 3:6] = rng.uniform(0.5, 4, (bs, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (bs, g))
    boxes[..., 7:] = rng.normal(size=(bs, g, 2))
    valid = np.zeros((bs, g), bool)
    valid[:, :n_valid] = True
    labels = rng.integers(0, 10, (bs, g)).astype(np.int32)
    labels[0, 0] = 9  # a class-wise reg-weight override
    return boxes, labels, valid


def test_sample_targets3d_matches_jax():
    rng = np.random.default_rng(8)
    boxes, labels, valid = _gt3d(rng, 2, 6, 4)
    cls = rng.normal(size=(2, 16, 10)).astype(np.float32)
    reg = rng.normal(size=(2, 16, 10)).astype(np.float32) * 5
    ref = _jit(jt3.sample_targets3d, cls, reg, boxes, labels, valid)
    got = tt3.sample_targets3d(_t(cls), _t(reg), _t(boxes), _t(labels),
                               _t(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r)
    _close(tt3.encode_gt(_t(boxes), _t(valid)),
           _jit(jt3.encode_gt, boxes, valid))


def test_sample_targets2d_matches_jax():
    rng = np.random.default_rng(9)
    bs, cams, k, g2 = 1, 3, 6, 4
    cls = rng.normal(size=(bs, cams * k, 10)).astype(np.float32)
    box = rng.uniform(0.1, 0.9, (bs, cams * k, 4)).astype(np.float32)
    box[..., 2:] *= 0.3
    slot_valid = rng.uniform(size=(bs, cams * k)) > 0.3
    x1 = rng.uniform(0, 40, (bs, cams, g2, 2))
    gtb = np.concatenate([x1, x1 + rng.uniform(2, 20, (bs, cams, g2, 2))],
                         -1).astype(np.float32)
    gtl = rng.integers(0, 10, (bs, cams, g2)).astype(np.int32)
    gta = rng.uniform(-3, 3, (bs, cams, g2)).astype(np.float32)
    gtv = rng.uniform(size=(bs, cams, g2)) > 0.4
    ref = _jit(jt2.sample_targets2d, cls, box, slot_valid, gtb, gtl, gta,
               gtv, image_wh=(64, 32))
    got = tt2.sample_targets2d(_t(cls), _t(box), _t(slot_valid), _t(gtb),
                               _t(gtl), _t(gta), _t(gtv), (64, 32))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r)


def test_trans_cost3d_matches_jax():
    rng = np.random.default_rng(10)
    bs, cams, k, g2, a3, g3 = 2, 3, 4, 3, 7, 5
    cost2d = rng.normal(size=(bs, cams, k, g2)).astype(np.float32)
    slot_valid = rng.uniform(size=(bs, cams * k)) > 0.3
    gtv = rng.uniform(size=(bs, cams, g2)) > 0.3
    gmap = rng.integers(0, g3, (bs, cams, g2)).astype(np.int32)
    tm = (rng.uniform(size=(bs, cams * k, a3)) > 0.7).astype(np.float32)
    ref = _jit(jt2.trans_cost3d, cost2d, slot_valid, gtv, gmap, tm,
               num_gt3d=g3)
    got = tt2.trans_cost3d(_t(cost2d), _t(slot_valid), _t(gtv), _t(gmap),
                           _t(tm), g3)
    _close(got, ref)


# ------------------------------------------------------------------- DN
DN_KW = dict(num_dn_groups=2, max_dn_gt=4, add_neg_dn=True, num_cams=3)


def _dn_inputs(seed=11):
    rng = np.random.default_rng(seed)
    bs, g, cams = 2, 6, 3
    boxes, labels, valid = _gt3d(rng, bs, g, 3)
    inst = np.arange(bs * g).reshape(bs, g).astype(np.int32)
    vis = rng.uniform(size=(bs, g, cams)) > 0.4
    b2d = rng.uniform(0, 40, (bs, g, cams, 4)).astype(np.float32)
    l2d = rng.integers(0, 10, (bs, g, cams)).astype(np.int32)
    a2d = rng.uniform(-1, 1, (bs, g, cams)).astype(np.float32)
    return boxes, labels, valid, inst, vis, b2d, l2d, a2d


def _bundle_np(bundle):
    return {f.name: np.asarray(getattr(bundle, f.name))
            for f in dataclasses.fields(bundle)}


DN_SEED = 3


@functools.lru_cache(maxsize=None)
def _jax_dn_bundle():
    """JAX's DN bundle of `_dn_inputs()` from PRNGKey(DN_SEED), compiled
    once for the tests that need one."""
    return jax.jit(lambda k, *a: jt3.get_dn_anchors(
        k, *a[:3], gt_instance_id=a[3], gt_vis2d=a[4], gt_boxes2d=a[5],
        gt_labels2d=a[6], gt_alphas2d=a[7], **DN_KW))(
            jax.random.PRNGKey(DN_SEED), *_dn_inputs())


def _dn_uniforms(key, shape):
    """The three uniforms `get_dn_anchors` draws from `key`."""
    k1, k2, k3 = jax.random.split(key, 3)
    return tuple(_t(jax.random.uniform(k, shape)) for k in (k1, k2, k3))


def test_get_dn_anchors_matches_jax():
    inputs = _dn_inputs()
    ref = _bundle_np(_jax_dn_bundle())
    draws = _dn_uniforms(jax.random.PRNGKey(DN_SEED),
                         (DN_KW["num_dn_groups"] * 2, 4, 10))
    got = tt3.get_dn_anchors(draws, *[_t(a) for a in inputs[:3]],
                             *[_t(a) for a in inputs[3:]], **DN_KW)
    for name, r in ref.items():
        g = getattr(got, name)
        if r.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
        else:
            _close(g, r, msg=name)
    # the generator path draws the same shapes
    gen = torch.Generator().manual_seed(0)
    again = tt3.get_dn_anchors(gen, *[_t(a) for a in inputs[:3]], **DN_KW)
    assert again.dn_anchor.shape == got.dn_anchor.shape


def _dn_state_np(rng, bs, gt, num_per, c, cams, ids):
    return {
        "feature": rng.normal(size=(bs, gt, num_per, c)).astype(np.float32),
        "anchor": rng.normal(size=(bs, gt, num_per, 11)).astype(np.float32),
        "cls_target": rng.integers(-1, 10, (bs, gt, num_per)).astype(
            np.int32),
        "valid_mask": rng.uniform(size=(bs, gt, num_per)) > 0.5,
        "id_target": ids,
        "trans_mask2d": rng.uniform(size=(bs, gt, num_per, cams)) > 0.5,
        "valid_mask2d": rng.uniform(size=(bs, gt, num_per, cams)) > 0.5,
        "cls_target2d": rng.integers(-1, 10, (bs, gt, num_per, cams)).astype(
            np.int32),
        "alpha_target2d": rng.normal(size=(bs, gt, num_per, cams)).astype(
            np.float32),
    }


def test_update_and_cache_dn_match_jax():
    jb = _jax_dn_bundle()
    bnp = _bundle_np(jb)
    bs, num_dn = bnp["cls_target"].shape
    num_per, c, a3, cams = num_dn // 2, 8, 5, 3
    rng = np.random.default_rng(12)
    ids = bnp["id_target"].reshape(bs, 2, num_per)[:, :1].copy()
    ids[:, :, ::3] = 999  # some cached ids have no current match
    snp = _dn_state_np(rng, bs, 1, num_per, c, cams, ids)
    feat = rng.normal(size=(bs, a3 + num_dn, c)).astype(np.float32)
    anchor = rng.normal(size=(bs, a3 + num_dn, 11)).astype(np.float32)
    tvm = np.array([True, False])
    ref = jax.jit(lambda f, a, b, s, m: jdn.update_dn(
        f, a, b, s, m, a3, 2, 1))(feat, anchor, jb, jdn.DnState(**snp), tvm)
    tb = dn_bundle_from_numpy(bnp, device="cpu")
    got = tdn.update_dn(_t(feat), _t(anchor), tb,
                        dn_state_from_numpy(snp, device="cpu"), _t(tvm), a3,
                        2, 1)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    rb = _bundle_np(ref[2])
    for name, r in rb.items():
        g = getattr(got[2], name).numpy()
        np.testing.assert_allclose(g.astype(np.float32),
                                   r.astype(np.float32), rtol=RTOL,
                                   err_msg=name)
    # cache_dn with JAX's group scores
    key2 = jax.random.PRNGKey(9)
    dn_feat = rng.normal(size=(bs, num_dn, c)).astype(np.float32)
    dn_anchor = rng.normal(size=(bs, num_dn, 11)).astype(np.float32)
    jref = jax.jit(lambda k, f, a, b: jdn.cache_dn(k, f, a, b, 2, 1))(
        key2, dn_feat, dn_anchor, jb)
    scores = _t(jax.random.uniform(key2, (2,)))
    tref = tdn.cache_dn(scores, _t(dn_feat), _t(dn_anchor), tb, 2, 1)
    for f in dataclasses.fields(jref):
        np.testing.assert_allclose(
            getattr(tref, f.name).numpy().astype(np.float32),
            np.asarray(getattr(jref, f.name)).astype(np.float32),
            err_msg=f.name)


# ------------------------------------------------------------ grid mask
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grid_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(jgm.grid_mask)(key, img)
    k_apply, k_d, k_sh, k_sw = jax.random.split(key, 4)
    d = int(jax.random.randint(k_d, (), 2, 32))
    draws = (float(jax.random.uniform(k_apply)), d,
             int(jax.random.randint(k_sh, (), 0, d)),
             int(jax.random.randint(k_sw, (), 0, d)))
    _close(tgm.grid_mask(draws, _t(img)), ref)
    for args in ((32, 64, 7, 3, 2, 5), (20, 30, 4, 2, 0, 3)):
        np.testing.assert_array_equal(tgm.keep_mask(*args).numpy(),
                                      np.asarray(jgm.keep_mask(*args)))
    gen = torch.Generator().manual_seed(seed)
    assert tgm.grid_mask(gen, _t(img)).shape == img.shape


# ----------------------------------------------------------- total loss
Alloc = collections.namedtuple("Alloc", "valid")


def _outputs_np(rng, bs=1, a=12, q2=6, cams=3, layers=2, layers2d=2):
    out = {
        "classification": [rng.normal(size=(bs, a, 10)) for _ in
                           range(layers)],
        "prediction": [rng.normal(size=(bs, a, 11)) * 3 for _ in
                       range(layers)],
        "quality": [rng.normal(size=(bs, a, 2)) for _ in range(layers)],
        "classification2d": [rng.normal(size=(bs, q2 * cams, 10)) for _ in
                             range(layers2d)],
        "prediction2d": [rng.uniform(0.1, 0.9, (bs, q2 * cams, 4)) for _ in
                         range(layers2d)],
        "prediction_alpha2d": [rng.normal(size=(bs, q2 * cams, 2)) for _ in
                               range(layers2d)],
        "alloc_valid": [rng.uniform(size=(bs, q2 * cams)) > 0.3 for _ in
                        range(layers2d)],
        "depth_preds": [rng.uniform(1, 70, (bs, cams, 4, 8)),
                        rng.uniform(1, 70, (bs, cams, 2, 4))],
    }
    return {k: [np.asarray(x, np.float32) if x.dtype != bool else x
                for x in v] for k, v in out.items()}


def test_total_loss_matches_jax():
    rng = np.random.default_rng(13)
    cams = 3
    o = _outputs_np(rng)
    jb = jax.tree_util.tree_map(lambda x: x[:1], _jax_dn_bundle())
    jb = jb.replace(attn_mask=jnp.zeros((16, 16), bool))
    bnp = _bundle_np(jb)
    num_dn = bnp["cls_target"].shape[1]
    kd = 2
    dn_out = {
        "dn_classification": [rng.normal(size=(1, num_dn, 10)).astype(
            np.float32) for _ in range(2)],
        "dn_prediction": [rng.normal(size=(1, num_dn, 11)).astype(
            np.float32) for _ in range(2)],
        "dn_classification2d": [rng.normal(size=(1, kd * cams, 10)).astype(
            np.float32) for _ in range(2)],
        "dn_prediction2d": [rng.uniform(0.1, 0.9, (1, kd * cams, 4)).astype(
            np.float32) for _ in range(2)],
        "dn_prediction_alpha2d": [rng.normal(size=(1, kd * cams, 2)).astype(
            np.float32) for _ in range(2)],
        "dn_slot_targets": [{
            "cls": rng.integers(-1, 10, (1, kd * cams)).astype(np.int32),
            "box": rng.uniform(0, 40, (1, kd * cams, 4)).astype(np.float32),
            "alpha": rng.normal(size=(1, kd * cams)).astype(np.float32),
            "valid": rng.uniform(size=(1, kd * cams)) > 0.3,
        } for _ in range(2)],
    }
    boxes, labels, valid = _gt3d(rng, 1, 5, 3)
    g2 = 4
    x1 = rng.uniform(0, 40, (1, cams, g2, 2))
    batch = {
        "gt_boxes3d": boxes, "gt_labels3d": labels, "gt_valid3d": valid,
        "gt_boxes2d": np.concatenate(
            [x1, x1 + rng.uniform(2, 20, (1, cams, g2, 2))], -1).astype(
                np.float32),
        "gt_labels2d": rng.integers(0, 10, (1, cams, g2)).astype(np.int32),
        "gt_alphas2d": rng.uniform(-3, 3, (1, cams, g2)).astype(np.float32),
        "gt_valid2d": rng.uniform(size=(1, cams, g2)) > 0.3,
        "gt_depth": [np.where(rng.uniform(size=(1, cams, 4, 8)) > 0.7,
                              rng.uniform(1, 60, (1, cams, 4, 8)), 0.0)
                     .astype(np.float32),
                     np.zeros((1, cams, 2, 4), np.float32)],
    }

    def assemble(conv, bundle, alloc_cls):
        outs = {k: [conv(x) for x in v] for k, v in o.items()
                if k != "alloc_valid"}
        outs["allocations"] = [alloc_cls(conv(v)) for v in o["alloc_valid"]]
        for k, v in dn_out.items():
            outs[k] = ([{kk: conv(vv) for kk, vv in d.items()} for d in v]
                       if k == "dn_slot_targets" else [conv(x) for x in v])
        outs["dn_bundle_first"] = outs["dn_bundle_temp"] = bundle
        b = {k: ([conv(x) for x in v] if isinstance(v, list) else conv(v))
             for k, v in batch.items()}
        return outs, b

    jouts, jbatch = assemble(jnp.asarray, jb, Alloc)
    ref_total, ref = jax.jit(lambda ou, ba: jlh.total_loss(
        ou, ba, JTrainConfig(), image_wh=(64, 32)))(jouts, jbatch)
    touts, tbatch = assemble(_t, dn_bundle_from_numpy(bnp, device="cpu"),
                             Alloc)
    total, got = tlh.total_loss(touts, tbatch, TrainConfig(),
                                image_wh=(64, 32))
    assert set(got) == set(ref)
    assert "loss_cls3d_dn_1" in got and "loss_dense_depth" in got
    for k in ref:
        _close(got[k], ref[k], rtol=1e-5, atol=1e-6, msg=k)
    _close(total, ref_total, rtol=1e-5)


# ----------------------------------------------- optimizer and schedule
def test_lr_schedule_matches_optax():
    tc = TrainConfig()
    sched, jsched = tts.lr_schedule(tc), jts.lr_schedule(JTrainConfig())
    for step in (0, 1, 499, 500, 501, tc.max_iters // 2, tc.max_iters - 1):
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=RTOL, err_msg=str(step))


class _Tree(torch.nn.Module):
    """A small tree with "backbone", "frozen" and "default" leaves."""

    def __init__(self):
        super().__init__()
        self.img_backbone = torch.nn.Linear(4, 3)
        self.head = torch.nn.Module()
        self.head.fc = torch.nn.Linear(3, 5)
        self.head.instance_feature = torch.nn.Parameter(torch.zeros(2, 3))


def test_optimizer_update_matches_optax():
    rng = np.random.default_rng(14)
    tree = _Tree()
    with torch.no_grad():
        for p in tree.parameters():
            p.copy_(_t(rng.normal(size=p.shape).astype(np.float32)))
    params0 = {n: p.detach().numpy().copy()
               for n, p in tree.named_parameters()}
    # gradients large enough to clip in one group, not in the other
    grads = [{n: rng.normal(size=p.shape).astype(np.float32)
              * (40.0 if "backbone" in n else 0.5)
              for n, p in params0.items()} for _ in range(2)]

    def nest(flat):
        out = {}
        for n, v in flat.items():
            node = out
            *parents, leaf = n.split(".")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v)
        return out

    tc, jtc = TrainConfig(warmup_iters=2), JTrainConfig(warmup_iters=2)
    opt = jts.make_optimizer(jtc)
    update = jax.jit(opt.update)
    jparams = nest(params0)
    jstate = opt.init(jparams)
    state = tts.create_train_state(tree, tc)
    for g in grads:
        upd, jstate = update(nest(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tts.apply_optimizer(state, tc, {n: _t(v) for n, v in g.items()})
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    ref = {".".join(str(k.key) for k in path): np.asarray(v)
           for path, v in flat}
    assert state.step == 2
    for n, p in tree.named_parameters():
        _close(p, ref[n], rtol=1e-6, atol=1e-7, msg=n)
    np.testing.assert_array_equal(
        tree.head.instance_feature.detach().numpy(),
        params0["head.instance_feature"])
    assert tts._param_labels(tree.named_parameters()) == {
        "img_backbone.weight": "backbone", "img_backbone.bias": "backbone",
        "head.instance_feature": "frozen", "head.fc.weight": "default",
        "head.fc.bias": "default"}
