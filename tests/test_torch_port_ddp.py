"""Data-parallel training of the port over `torch.distributed` (gloo), on
the CPU in two spawned processes.

World-size invariance of the step: the tiny config with the fast knobs
(windowed MSDA), at depth 26, with the random parts on (DN noise,
dropout, the DFA point dropout, the grid mask, the allocation's corner
ranking and the DN cache's draw) and the trunk rematerialised, takes
two steps carrying its temporal and DN state, once in this process at
bs 2 (world 1) and once in two processes at bs 1 each (world 2, rank r
takes row r of the same global batch). The two worlds compute the same
function in other orders of summation (the BatchNorm statistics, the
gradients, the losses), so what a rounding can flip is taken from the
world-1 run: a rank takes its assignments (each cost matrix's nearest
world-1 matrix, which must agree to 1e-2 of its largest cost) and, at
step 2, its carried state; the trunk computes in float64 (`_float64_
trunk`), and the learning rate is LR (see there). Held: every loss of
both steps within 1e-5 relative, step 1's reduced gradients within
GRAD_TOL of each gradient's largest value plus GRAD_FLOOR, the
BatchNorm running statistics within 1e-6 of each buffer's largest value,
and the parameters, statistics and gradients bit-identical on the two
ranks.

Planted faults, monkeypatched in the same two processes after the
correct run and never switched in the program: BatchNorm statistics
left local, `_count` left local, gradients averaged instead of summed.
Each must fail the invariance check.

The training CLI at world 2 (`tools/train.py::run` in each process, its
process group set up by the worker; `--config tiny` at depth 26): three
iterations with checkpoints at 2 and 3 and the mid-training eval at 3
through `distributed_streaming_eval` with the score broadcast; then a
run resumed from `ckpt_2` at world 2, whose iteration-3 loss equals the
uninterrupted run's, and in which a preemption signal on rank 1 alone
stops both ranks after iteration 3; `--multihost` with a coordinator
nobody serves raises within its timeout. Then the `parallel/mesh.py`
helpers at world 2, and the identity at world 1, and the kernel
planners at the batch sizes of the data-parallel paths.

Each spawned process runs `torch.set_num_threads(1)` and has its own
timeout; no JAX is imported here.
"""
import dataclasses
import math
import os
import signal
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from simpb_tpu_torch.configs.base import TrainConfig, simpb_tiny
from simpb_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BS_GLOBAL = 2
STEPS = 2
SPAWN_TIMEOUT_S = 240
# step 1's gradients: within GRAD_TOL of each gradient's largest
# magnitude, plus GRAD_FLOOR for gradients that vanish in exact
# arithmetic (a key bias, which moves every logit of a row alike: both
# worlds hold rounding noise of 1e-9 there). On the CPU the head's
# batched matmul of the 2D-to-3D aggregation rounds one ulp apart at bs 1
# and bs 2, and through the later decoder layers (sampling positions,
# their bilinear corners) that grows to 2e-3 of a gradient's largest
# value; a planted fault moves them by 10-50 %.
GRAD_TOL, GRAD_FLOOR = 1e-2, 1e-6
LOSS_RTOL, STATS_TOL = 1e-5, 1e-6
# Adam's first update moves every parameter by +-lr whatever its
# gradient's size, so a gradient that is rounding noise in both worlds
# (0.15 % of them here) moves by 2 lr between them; at the schedule's
# 1.3e-4 that moves step 2's losses by up to 1e-4 relative. The step
# test's learning rate keeps that move below the loss bound.
LR = 1e-6
FAULTS = ("bn_local", "count_local", "grad_mean")


def _step_cfg():
    """The tiny config with the fast knobs at depth 26, remat on, every
    random part on (dropout 0.1, DFA point dropout 0.15, grid mask)."""
    cfg = simpb_tiny()
    head = dataclasses.replace(
        cfg.head, msda_patch_mode=True, msda_gather_capacity=6,
        dfa_gather_capacity=256, msda_sel_levels=2)
    return dataclasses.replace(cfg, head=head, backbone_depth=26,
                               backbone_remat=True)


def _float64_trunk(model):
    """The trunk and its BatchNorm in float64, its outputs rounded to
    fp32 for the head. A random-weight ResNet's training backward is
    ill-conditioned in fp32: the two worlds' orders of summation alone
    move its fp32 gradients by up to 0.5 % of their range here (as they
    move JAX's off its float64 evaluation,
    tests/test_torch_port_train_trunk.py)."""
    for mod in (model.img_backbone, model.img_neck, model.depth_branch):
        mod.double()
    model.compute_dtype = torch.float64
    extract = model.extract_feat_train

    def extract_fp32_out(*args, **kwargs):
        col, shapes, depths = extract(*args, **kwargs)
        return col.float(), shapes, [d.float() for d in depths]

    model.extract_feat_train = extract_fp32_out


def _rows(batch, lo, hi):
    """Rows lo:hi of every array of a numpy batch (lists per level)."""
    return {k: ([x[lo:hi] for x in v] if isinstance(v, list) else v[lo:hi])
            for k, v in batch.items()}


def _train(bs_local, rank, faults=(), impose=None):
    """STEPS steps of the step config at `bs_local` on this process's
    rows of the global batch (one step under a planted fault): the
    losses a step, step 1's reduced gradients, the final parameters and
    BatchNorm buffers, and the assignments.

    The assignment is per sample, but with random weights many
    predictions crowd around the origin and two of them can cost a
    ground-truth box within a rounding of each other: the two worlds,
    whose features differ by roundings, then break such a near-tie
    apart and their losses jump. So a rank's run takes, for each of its
    cost matrices, the assignment the world-1 run (`impose`: its
    recorded calls) made on the nearest of its matrices; the largest
    difference between the matched matrices (relative to the world-1
    matrix's largest cost) and the rows where the rank's own assignment
    differed are returned."""
    from simpb_tpu_torch.models import backbone
    from simpb_tpu_torch.training import loss_head, targets3d, train_step
    from simpb_tpu_torch.utils.synthetic import (
        batch_to_torch, synthetic_train_batch,
    )

    cfg = _step_cfg()
    patches = []

    def patch(mod, name, value):
        patches.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    if "bn_local" in faults:
        patch(backbone, "is_initialized", lambda: False)
    if "count_local" in faults:
        patch(loss_head, "_count",
              lambda m: torch.clamp(m.sum().float(), min=1.0))
    if "grad_mean" in faults:
        def mean_(ts):
            mesh.all_reduce_sum_(ts)
            if ts and ts[0].dim():  # the gradients, not the 0-d metrics
                for t in ts:
                    t.div_(mesh.process_count())
        patch(train_step, "all_reduce_sum_", mean_)
    grads = []
    real_apply = train_step.apply_optimizer

    def recording_apply(state, tc, g):
        if not grads:
            grads.append({n: t.clone() for n, t in g.items()})
        real_apply(state, tc, g)

    patch(train_step, "apply_optimizer", recording_apply)
    calls, assign_stats = [], dict(cost_rel=0.0, flipped_rows=0)
    real_assign = targets3d.batched_assignment

    def assign(cost, row_valid, pad_cost=1e6):
        own = real_assign(cost, row_valid, pad_cost)
        cost = torch.nan_to_num(cost, posinf=1e9, neginf=-1e9)
        if impose is None:
            calls.append((cost.clone(), row_valid.clone(), own.clone()))
            return own
        rcost, rvalid, rcol = impose["calls"][len(calls)]
        calls.append(None)
        out = torch.empty_like(own)
        for i in range(cost.shape[0]):
            diff = (rcost - cost[i]).abs().amax(dim=(1, 2))
            diff[~(rvalid == row_valid[i]).all(dim=1)] = math.inf
            j = int(diff.argmin())
            assign_stats["cost_rel"] = max(
                assign_stats["cost_rel"],
                float(diff[j]) / float(rcost[j].abs().max()))
            out[i] = rcol[j]
            assign_stats["flipped_rows"] += int(
                (own[i] != rcol[j])[row_valid[i]].sum())
        return out

    patch(targets3d, "batched_assignment", assign)
    try:
        tc = TrainConfig(batch_size=bs_local, lr=LR)
        model = train_step.build_train_model(cfg, device="cpu", seed=0)
        _float64_trunk(model)
        state = train_step.create_train_state(model, tc)
        step = train_step.build_train_step(model, tc)
        batch = _rows(synthetic_train_batch(cfg, BS_GLOBAL, seed=3,
                                            num_objects=6, max_gt3d=8,
                                            max_gt2d=6),
                      rank * bs_local, (rank + 1) * bs_local)
        batch = batch_to_torch(batch, "cpu")
        temporal, dn_state = train_step.init_temporal(cfg, bs_local, "cpu")
        losses, carried = [], []
        for s in range(STEPS if not faults else 1):
            if s and impose is not None:
                # the world-1 run's carried state, this rank's rows
                lo, hi = rank * bs_local, (rank + 1) * bs_local
                temporal, dn_state = (
                    dataclasses.replace(x, **{k: v[lo:hi]
                                              for k, v in ref.items()})
                    for x, ref in zip((temporal, dn_state),
                                      impose["carried"][s - 1]))
            state, temporal, dn_state, m = step(state, batch, temporal,
                                                dn_state, 7)
            losses.append({k: float(v) for k, v in m.items()})
            carried.append(tuple(
                {f.name: getattr(x, f.name).clone()
                 for f in dataclasses.fields(x)}
                for x in (temporal, dn_state)))
    finally:
        for mod, name, value in reversed(patches):
            setattr(mod, name, value)
    return dict(losses=losses, grads=grads[0], assign=assign_stats,
                calls=calls if impose is None else None, carried=carried,
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                buffers={n: b.clone() for n, b in model.named_buffers()
                         if "running" in n})


def invariance_errors(ref, got, steps=STEPS):
    """What breaks world-size invariance between the world-1 run `ref`
    and a rank's run `got`, as strings (empty: invariant)."""
    errs = []
    for s in range(min(steps, len(got["losses"]))):
        r, g = ref["losses"][s], got["losses"][s]
        if set(r) != set(g):
            errs.append(f"step {s + 1}: loss keys differ")
            continue
        for k in r:
            if not abs(g[k] - r[k]) <= LOSS_RTOL * abs(r[k]) + 1e-12:
                errs.append(f"step {s + 1} {k}: {g[k]} vs {r[k]}")
    for n, r in ref["grads"].items():
        top = float(r.abs().max())
        err = float((got["grads"][n] - r).abs().max())
        if not err <= GRAD_TOL * top + GRAD_FLOOR:
            errs.append(f"gradient {n}: {err}, largest {top}")
    if len(got["losses"]) == steps:
        for n, r in ref["buffers"].items():
            err = float((got["buffers"][n] - r).abs().max())
            if not err <= STATS_TOL * max(float(r.abs().max()), 1e-30):
                errs.append(f"BN statistic {n}: {err}")
    return errs


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(job, out_dir, world=2):
    """Run `job(rank, world, coordinator, out_dir)` of this module in
    `world` processes; returns their outputs, or raises with the
    failing process's output."""
    coordinator = f"127.0.0.1:{_free_port()}"
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {HERE!r})
        import torch
        torch.set_num_threads(1)
        import test_torch_port_ddp as t
        t.{job}(int(sys.argv[1]), {world}, {coordinator!r}, {out_dir!r})
    """)
    env = dict(os.environ, PYTHONPATH=REPO, SIMPB_NO_TB="1",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    return outs


def _mesh_checks(rank, world):
    """The helpers of `parallel/mesh.py` under a process group: what each
    returned on this rank."""
    out = {}
    xs = [torch.full((2, 3), float(rank + 1)),
          torch.arange(4, dtype=torch.float64) * (rank + 1),
          torch.tensor([rank + 1], dtype=torch.int32)]
    mesh.all_reduce_sum_(xs)
    out["all_reduce"] = xs
    out["gather_bool"] = mesh.all_gather_rows(
        torch.tensor([[rank == 0, True]]))
    out["gather_f64"] = mesh.all_gather_rows(
        torch.full((2, 2), rank + 0.5, dtype=torch.float64))
    out["broadcast"] = mesh.broadcast_float(3.25 if rank == 0 else -1.0)
    out["any_one"] = mesh.any_flag(rank == world - 1)
    out["any_none"] = mesh.any_flag(False)
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = mesh.all_reduce_sum(x * (rank + 1))
    (y * torch.tensor([1.0, 10.0])).sum().backward()
    out["sum_fwd"], out["sum_grad"] = y.detach(), x.grad
    gen = torch.Generator().manual_seed(5)
    out["draw"] = mesh.batch_slice_draw(
        lambda shp: torch.rand(shp, generator=gen), (2, 3), axis=1)
    mesh.host_barrier("test")
    mesh.check_replicated([torch.ones(3)], "equal tensors")
    try:
        mesh.check_replicated([torch.full((3,), float(rank))], "ranks")
        out["replicated_raised"] = False
    except RuntimeError:
        out["replicated_raised"] = True
    return out


def step_job(rank, world, coordinator, out_dir):
    """The worker of the step test: the correct run, then each planted
    fault, one file each; the world-1 run's assignments imposed."""
    impose = torch.load(os.path.join(out_dir, "ref_calls.pt"),
                        weights_only=True)
    mesh.initialize_multihost(coordinator, world, rank, device="cpu",
                              timeout_s=120)
    try:
        torch.save(_mesh_checks(rank, world),
                   os.path.join(out_dir, f"mesh_{rank}.pt"))
        bs = BS_GLOBAL // world
        torch.save(_train(bs, rank, impose=impose),
                   os.path.join(out_dir, f"ok_{rank}.pt"))
        for fault in FAULTS:
            torch.save(_train(bs, rank, (fault,), impose=impose),
                       os.path.join(out_dir, f"{fault}_{rank}.pt"))
    finally:
        mesh.shutdown()


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """World 1 in this process, then world 2 in two spawned processes
    (the correct run and the planted faults)."""
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("ddp_step"))
    ref = _train(BS_GLOBAL, 0)
    torch.save(dict(calls=ref.pop("calls"), carried=ref["carried"]),
               os.path.join(out, "ref_calls.pt"))
    _spawn("step_job", out)
    load = lambda name: torch.load(os.path.join(out, name),
                                   weights_only=True)
    return dict(ref=ref, ranks=[load(f"ok_{r}.pt") for r in range(2)],
                mesh=[load(f"mesh_{r}.pt") for r in range(2)],
                faults={f: [load(f"{f}_{r}.pt") for r in range(2)]
                        for f in FAULTS})


def test_world_size_invariance(step_runs):
    ref = step_runs["ref"]
    for rank, got in enumerate(step_runs["ranks"]):
        errs = invariance_errors(ref, got)
        assert not errs, f"rank {rank}: {errs[:6]}"
    r0, r1 = step_runs["ranks"]
    for kind in ("params", "buffers", "grads"):
        for n, v in r0[kind].items():
            assert torch.equal(v, r1[kind][n]), (kind, n)
    assert len(ref["grads"]) > 100
    # the imposed assignments were made on the same matrices, up to the
    # worlds' roundings
    for got in step_runs["ranks"]:
        assert got["assign"]["cost_rel"] <= 1e-2, got["assign"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_breaks_invariance(step_runs, fault):
    for rank, got in enumerate(step_runs["faults"][fault]):
        assert invariance_errors(step_runs["ref"], got), (fault, rank)


def test_mesh_helpers_at_world_2(step_runs):
    gen = torch.Generator().manual_seed(5)
    full = torch.rand((2, 6), generator=gen)  # the global draw
    for rank, got in enumerate(step_runs["mesh"]):
        a, b, c = got["all_reduce"]
        assert torch.equal(a, torch.full((2, 3), 3.0))
        assert torch.equal(b, torch.arange(4, dtype=torch.float64) * 3)
        assert b.dtype == torch.float64 and c.dtype == torch.int32
        assert torch.equal(c, torch.tensor([3], dtype=torch.int32))
        assert torch.equal(got["gather_bool"],
                           torch.tensor([[True, True], [False, True]]))
        assert torch.equal(got["gather_f64"], torch.tensor(
            [[0.5, 0.5], [0.5, 0.5], [1.5, 1.5], [1.5, 1.5]],
            dtype=torch.float64))
        assert got["broadcast"] == 3.25
        assert got["any_one"] and not got["any_none"]
        # y = x * 1 + x * 2 on both; each rank's loss y . (1, 10) sends
        # (1, 10) * 2 ranks back through the all-reduce, times rank + 1
        assert torch.equal(got["sum_fwd"], torch.tensor([3.0, 6.0]))
        assert torch.equal(got["sum_grad"],
                           torch.tensor([2.0, 20.0]) * (rank + 1))
        assert torch.equal(got["draw"], full[:, 3 * rank:3 * rank + 3])
        assert got["replicated_raised"]


def test_mesh_helpers_at_world_1():
    """Without a process group every helper is the identity."""
    assert not mesh.is_initialized()
    assert mesh.process_count() == 1 and mesh.process_index() == 0
    x = torch.arange(6.0).reshape(2, 3)
    y = x.clone()
    mesh.all_reduce_sum_([y])
    assert torch.equal(y, x)
    assert mesh.all_gather_rows(x) is x
    assert mesh.all_reduce_sum(x) is x
    assert mesh.broadcast_float(2.5) == 2.5
    assert mesh.any_flag(True) and not mesh.any_flag(False)
    mesh.host_barrier("alone")
    mesh.check_replicated([x], "alone")
    gen = torch.Generator().manual_seed(1)
    want = torch.rand((3, 2), generator=gen.manual_seed(1))
    assert torch.equal(mesh.batch_slice_draw(
        lambda s: torch.rand(s, generator=gen.manual_seed(1)), (3, 2)),
        want)


# the training CLI at world 2 -------------------------------------------

CLI_SRC_HW = (80, 160)  # the CLI's 0.40-0.47 resize covers 64x32


def _cli_argv(pkl, work, *extra):
    return ["--ann-file", pkl, "--config", "tiny", "--device", "cpu",
            "--batch-size", "1", "--log-interval", "1", "--src-h",
            str(CLI_SRC_HW[0]), "--src-w", str(CLI_SRC_HW[1]),
            "--work-dir", work, *extra]


def cli_job(rank, world, coordinator, out_dir):
    """The worker of the CLI tests: a 3-iteration run with checkpoints
    at 2 and 3 and the eval at 3, and a run resumed from `ckpt_2` to 4
    with a preemption signal on rank 1 alone at iteration 3. `--config
    tiny` at depth 26."""
    from simpb_tpu_torch.tools import train as train_cli
    from simpb_tpu_torch.utils import synthetic

    build = train_cli.build_config
    train_cli.build_config = lambda args: dataclasses.replace(
        build(args), backbone_depth=26)
    pkl = os.path.join(out_dir, "data", "infos.pkl")
    mesh.initialize_multihost(coordinator, world, rank, device="cpu",
                              timeout_s=120)
    try:
        first = train_cli.run(train_cli.parse_args(_cli_argv(
            pkl, os.path.join(out_dir, "work"), "--max-iters", "3",
            "--ckpt-interval", "2", "--eval-ann-file", pkl,
            "--eval-interval", "3", "--eval-frames", "4")))
        to_torch = synthetic.batch_to_torch
        seen = []

        def preempt_at_3(batch, device=None):
            seen.append(1)
            if rank == 1 and len(seen) == 1:  # iteration 3
                os.kill(os.getpid(), signal.SIGUSR1)
            return to_torch(batch, device)

        synthetic.batch_to_torch = preempt_at_3
        try:
            second = train_cli.run(train_cli.parse_args(_cli_argv(
                pkl, os.path.join(out_dir, "work2"), "--max-iters", "4",
                "--ckpt-interval", "10", "--resume-from",
                os.path.join(out_dir, "work", "ckpt_2"))))
        finally:
            synthetic.batch_to_torch = to_torch
    finally:
        mesh.shutdown()
    keep = ("losses", "checkpoints", "evals", "start_iter", "best_score")
    torch.save(dict(first={k: first[k] for k in keep},
                    second={k: second[k] for k in keep},
                    preempted_at=second.get("preempted_at"),
                    prev_pose=first["prev_pose"]),
               os.path.join(out_dir, f"cli_{rank}.pt"))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    out = str(tmp_path_factory.mktemp("ddp_cli"))
    write_synthetic_infos(os.path.join(out, "data"), n_frames=8,
                          gap_at=(4,), src_hw=CLI_SRC_HW, num_objects=8,
                          write_images=True, with_2d=True, with_lidar=True)
    _spawn("cli_job", out)
    return dict(dir=out, ranks=[
        torch.load(os.path.join(out, f"cli_{r}.pt"), weights_only=False)
        for r in range(2)])


def test_cli_world_2_trains_checkpoints_and_evaluates(cli_runs):
    from simpb_tpu_torch.training.checkpoint import FORMAT

    r0, r1 = cli_runs["ranks"]
    work = os.path.join(cli_runs["dir"], "work")
    # the global batch's losses, equal on both ranks, every iteration
    assert sorted(r0["first"]["losses"]) == [1, 2, 3]
    assert r0["first"]["losses"] == r1["first"]["losses"]
    assert all(math.isfinite(v) for v in r0["first"]["losses"][3].values())
    # rank 0 wrote each checkpoint once, with both ranks' stream slots
    assert [c["bytes"] is not None for c in r0["first"]["checkpoints"]] \
        == [True] * len(r0["first"]["checkpoints"])
    assert all(c["bytes"] is None for c in r1["first"]["checkpoints"])
    ckpt = torch.load(os.path.join(work, "ckpt_3"), weights_only=True)
    assert ckpt["format"] == FORMAT and ckpt["step"] == 3
    assert ckpt["temporal"]["feature"].shape[0] == 2
    assert ckpt["dn_state"]["feature"].shape[0] == 2
    assert len(ckpt["prev_pose"]["has"]) == 2
    # the mid-training eval: rank 0 scored both shards, the score went
    # to both ranks, and both saved ckpt_best on it
    parts = sorted(os.listdir(os.path.join(work, "eval_gather_3")))
    assert parts == ["part_0.pkl", "part_1.pkl"]
    (e0,), (e1,) = r0["first"]["evals"], r1["first"]["evals"]
    assert {"mAP", "NDS"} <= set(e0["metrics"]) and e1["metrics"] == {}
    assert e0["score"] == e1["score"] == pytest.approx(
        e0["metrics"]["NDS"], abs=1e-12)
    assert e0["frames"] == 8 and e1["frames"] == 0
    assert r0["first"]["best_score"] == r1["first"]["best_score"]
    assert os.path.exists(os.path.join(work, "ckpt_best"))


def test_cli_world_2_resume_matches_uninterrupted(cli_runs):
    for got in cli_runs["ranks"]:
        assert got["second"]["start_iter"] == 2
        assert got["second"]["losses"][3] == got["first"]["losses"][3]


def test_cli_world_2_preemption_on_one_rank_stops_both(cli_runs):
    work2 = os.path.join(cli_runs["dir"], "work2")
    for got in cli_runs["ranks"]:
        assert got["preempted_at"] == 3
        assert sorted(got["second"]["losses"]) == [3]
    assert sorted(os.listdir(work2)) == ["ckpt_preempt_3"]


def test_multihost_unreachable_coordinator_raises(monkeypatch, tmp_path):
    """A rank whose coordinator nobody serves raises within the
    rendezvous timeout; it never trains alone."""
    import time

    from simpb_tpu_torch.tools import train as train_cli

    monkeypatch.setattr(mesh, "INIT_TIMEOUT_S", 2.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        train_cli.main(_cli_argv(
            "none.pkl", str(tmp_path), "--multihost", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", "2",
            "--process-id", "1"))
    assert time.perf_counter() - t0 < 60
    assert not mesh.is_initialized()


# ResNet-50 stages at 704x256: (mid channels, out channels, output H, W,
# stride of the stage head)
STAGES = ((64, 256, 64, 176, 1), (128, 512, 32, 88, 2),
          (256, 1024, 16, 44, 2), (512, 2048, 8, 22, 2))


@pytest.mark.parametrize("bs", [1, 2, 4])
def test_planners_take_the_batch_sizes(bs):
    """Every kernel planner of the trained and served configs' paths
    plans the batch sizes
    of the data-parallel paths: the multi-slot eval's bs 4 (24 images a
    trunk call), a training rank's bs 2, the one process's bs 4. A
    refusal here would be a fault, not a shape to avoid."""
    from simpb_tpu_torch.ops import conv_fused, sampling

    shapes = ((64, 176), (32, 88), (16, 44), (8, 22))
    b, cin = 6 * bs, 64
    for cm, co, h, w, s in STAGES:
        conv_fused.plan_bottleneck_down_tc(b, h * s, w * s, cin, cm, co, s)
        conv_fused.plan_bottleneck_tc(b, h, w, co, cm)
        conv_fused.plan_conv3x3_tc(b, h, w, 256, 256)
        cin = co
    for anchors in (900, 900 + 5 * 2 * 32):  # serving; training with DN
        sampling.plan_dfa(bs, 6, anchors, 13, 8, 256, 2048, shapes)
        sampling.plan_dfa_backward(bs, 6, anchors, 13, 8, 256, 2048, shapes)
    for dtype in (torch.float32, torch.bfloat16):
        sampling.plan_msda_sel(b, 208, 32, 8, 256, 2, 8, 8, dtype, shapes)
    sampling.plan_msda_sel_backward(b, 208, 32, 8, 256, 2, 8, 8, shapes)
    # exact MSDA (`simpb_r50_704x256`): 256 + 128 DN slots a camera row
    for q in (256, 384):
        sampling.plan_msda(b, q, 8, 4, 256, shapes)
        sampling.plan_msda_backward(b, q, 8, 4, 256, shapes)
