"""The port's batched target assignment and kernel C's planner, on the
CPU at tiny sizes.

`loss3d` and `loss2d` assign all their decoder layers' cost matrices in
one `batched_assignment` call (one launch of kernel A a kind on the
card, not one a layer): each layer must get exactly the targets the
per-layer `sample_targets3d` / `sample_targets2d` give it, and the loss
dict the per-layer assembly gives (equality: the same plain assignment
and the same float operations, so no tolerance). The plain assignment
counts its serial Dijkstra steps, the chain kernel A walks: a matrix of
padded rows takes R (R + 1) / 2 of them. Kernel C's planner sizes C1's
scratch and C3's tiles and channel slices. The losses against JAX are
`tests/test_torch_port_train.py::test_total_loss_matches_jax` (two
layers of each kind).
"""
import collections

import numpy as np
import pytest
import torch

from simpb_tpu_torch.configs.base import TrainConfig
from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.training import loss_head as tlh
from simpb_tpu_torch.training import matching as tmatch
from simpb_tpu_torch.training import targets2d as tt2
from simpb_tpu_torch.training import targets3d as tt3

torch.set_num_threads(1)
Alloc = collections.namedtuple("Alloc", "valid")


def _recorded(monkeypatch):
    """Record the shapes of every assignment call (all made in
    targets3d)."""
    calls = []
    real = tt3.batched_assignment

    def call(cost, valid, pad):
        calls.append((tuple(cost.shape), tuple(valid.shape)))
        return real(cost, valid, pad)

    monkeypatch.setattr(tt3, "batched_assignment", call)
    return calls


def _gt3d(rng, bs, g, n_valid):
    boxes = np.zeros((bs, g, 9), np.float32)
    boxes[..., :3] = rng.uniform(-20, 20, (bs, g, 3))
    boxes[..., 3:6] = rng.uniform(0.5, 4, (bs, g, 3))
    boxes[..., 6] = rng.uniform(-3, 3, (bs, g))
    boxes[..., 7:] = rng.normal(size=(bs, g, 2))
    valid = np.zeros((bs, g), bool)
    valid[:, :n_valid] = True
    labels = rng.integers(0, 10, (bs, g)).astype(np.int32)
    labels[0, 0] = 9  # a class-wise reg-weight override
    return (torch.from_numpy(boxes), torch.from_numpy(labels),
            torch.from_numpy(valid))


def test_loss3d_assigns_every_layer_in_one_call(monkeypatch):
    rng = np.random.default_rng(0)
    bs, n, layers = 2, 16, 3
    boxes, labels, valid = _gt3d(rng, bs, 6, 4)
    valid[1, 3] = False
    outs = {
        "classification": [torch.from_numpy(rng.normal(size=(bs, n, 10))
                                            .astype(np.float32))
                           for _ in range(layers)],
        "prediction": [torch.from_numpy((rng.normal(size=(bs, n, 11)) * 5)
                                        .astype(np.float32))
                       for _ in range(layers)],
        "quality": [torch.from_numpy(rng.normal(size=(bs, n, 2))
                                     .astype(np.float32))
                    for _ in range(layers)],
    }
    tc, cfg = TrainConfig(), tt3.TargetConfig()
    calls = _recorded(monkeypatch)
    got = tlh.loss3d(outs, boxes, labels, valid, tc, cfg)
    assert calls == [((layers * bs, 6, n), (layers * bs, 6))]
    d = len(tc.reg_weights)
    for idx in range(layers):
        cls, reg = outs["classification"][idx], outs["prediction"][idx]
        ref = tt3.sample_targets3d(cls, reg[..., :d], boxes, labels, valid,
                                   cfg)
        cost, enc, w = tt3.cost3d(cls, reg[..., :d], boxes, labels, valid,
                                  cfg)
        col = tmatch.batched_assignment(cost, valid)
        for a, b in zip(tt3.targets3d(col, enc, w, labels, valid,
                                      reg[..., :d], 10), ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the per-layer assembly, one call a layer
    monkeypatch.setattr(tlh, "assign_layers",
                        lambda costs, valid: [tt3.assign_layers([c], valid)[0]
                                              for c in costs])
    ref = tlh.loss3d(outs, boxes, labels, valid, tc, cfg)
    assert calls[1:] == [((bs, 6, n), (bs, 6))] * (2 * layers)
    assert set(got) == set(ref)
    assert {f"loss_cls3d_{i}" for i in range(layers)} <= set(got)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0)


def test_loss2d_assigns_every_layer_in_one_call(monkeypatch):
    rng = np.random.default_rng(1)
    bs, cams, k, g2, layers = 1, 3, 5, 4, 3
    q = cams * k
    x1 = rng.uniform(0, 40, (bs, cams, g2, 2))
    gtb = torch.from_numpy(np.concatenate(
        [x1, x1 + rng.uniform(2, 20, (bs, cams, g2, 2))], -1)
        .astype(np.float32))
    gtl = torch.from_numpy(rng.integers(0, 10, (bs, cams, g2))
                           .astype(np.int32))
    gta = torch.from_numpy(rng.uniform(-3, 3, (bs, cams, g2))
                           .astype(np.float32))
    gtv = torch.from_numpy(rng.uniform(size=(bs, cams, g2)) > 0.4)
    outs = {
        "classification2d": [torch.from_numpy(rng.normal(size=(bs, q, 10))
                                              .astype(np.float32))
                             for _ in range(layers)],
        "prediction2d": [torch.from_numpy(rng.uniform(0.1, 0.9, (bs, q, 4))
                                          .astype(np.float32))
                         for _ in range(layers)],
        "prediction_alpha2d": [torch.from_numpy(rng.normal(size=(bs, q, 2))
                                                .astype(np.float32))
                               for _ in range(layers)],
        "allocations": [Alloc(torch.from_numpy(rng.uniform(size=(bs, q))
                                               > 0.3))
                        for _ in range(layers)],
    }
    calls = _recorded(monkeypatch)
    got = tlh.loss2d(outs, gtb, gtl, gta, gtv, (64, 32), TrainConfig())
    assert calls == [((layers * bs * cams, g2, k),
                      (layers * bs * cams, g2))]
    del calls[:]
    for idx in range(layers):
        args = (outs["classification2d"][idx], outs["prediction2d"][idx],
                outs["allocations"][idx].valid)
        ref = tt2.sample_targets2d(*args, gtb, gtl, gta, gtv, (64, 32))
        cost = tt2.cost2d(*args, gtb, gtl, gtv, (64, 32))
        col = tmatch.batched_assignment(cost, gtv.reshape(bs * cams, g2))
        for a, b in zip(tt2.targets2d(col, gtb, gtl, gta, gtv, q), ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the per-layer assembly, one call a layer
    monkeypatch.setattr(tlh, "assign_layers",
                        lambda costs, valid: [tt3.assign_layers([c], valid)[0]
                                              for c in costs])
    ref = tlh.loss2d(outs, gtb, gtl, gta, gtv, (64, 32), TrainConfig())
    assert calls == [((bs * cams, g2, k), (bs * cams, g2))] * (2 * layers)
    assert set(got) == set(ref)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0)


def test_plain_assignment_counts_the_padded_chain():
    """Padded rows tie at the pad cost: padded row k walks the columns of
    the k rows before it, k + 1 steps, R (R + 1) / 2 in all; a matrix
    whose rows each find a free best column takes one step a row."""
    r, c = 6, 9
    steps = []
    col = tmatch.batched_assignment_plain(
        torch.zeros(2, r, c), torch.tensor([[False] * r, [True] * r]),
        steps=steps)
    assert steps[0] == r * (r + 1) // 2
    assert steps[1] == r * (r + 1) // 2  # all-zero rows tie the same way
    assert sorted(col[0].tolist()) == list(range(r))
    steps = []
    tmatch.linear_sum_assignment_plain(-torch.eye(r, c), steps)
    assert steps == [r]


def test_assignment_refuses_other_devices():
    cost = torch.zeros(1, 3, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tmatch.batched_assignment(cost, torch.ones(1, 3, dtype=torch.bool,
                                                   device="meta"))


MAIN_LEVELS = ((64, 176), (32, 88), (16, 44), (8, 22))


@pytest.mark.parametrize("c, cpl, slices", [(256, 4, 2), (200, 4, 2),
                                            (64, 2, 1), (48, 2, 1),
                                            (32, 1, 1)])
def test_msda_backward_plan_sizes_scratch_and_tiles(c, cpl, slices):
    rows, queries, heads, k = 24, 336, 8, 2
    plan = tsmp.plan_msda_sel_backward(rows, queries, heads * 4, heads, c, k,
                                       8, 8, MAIN_LEVELS)
    tiles = 8 * 22 + 4 * 11 + 2 * 6 + 1 * 3  # 8x8 tiles, edges partial
    assert plan.grid == (queries, rows)
    assert plan.gvalue_grid == (tiles, rows, slices)
    assert plan.cpl == cpl
    assert plan.scratch == rows * queries * k * (heads * 64 + 1)
    assert list(plan.dims)[12:14] == [tiles, cpl]
    assert list(plan.dims)[14:] == tsmp._level_table(MAIN_LEVELS)
    assert 32 * cpl * slices >= c > 32 * cpl * (slices - 1)


def test_msda_backward_plan_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="a side"):
        tsmp.plan_msda_sel_backward(1, 4, 8, 2, 64, 1, 8, 8,
                                    ((8, 1 << 15),))
    with pytest.raises(ValueError, match="do not fit together"):
        tsmp.plan_msda_sel_backward(1, 4, 8, 2, 64, 3, 8, 8,
                                    MAIN_LEVELS[:2])
    for heads, c in ((16, 64), (8, 100)):
        with pytest.raises(ValueError, match="multiple of 8"):
            tsmp.plan_msda_sel_backward(1, 4, heads * 4, heads, c, 2, 8, 8,
                                        MAIN_LEVELS)
