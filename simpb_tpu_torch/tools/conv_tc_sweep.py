"""Time every launch plan of the bf16 tensor-core kernels (K2, K3, K4
of csrc/conv_tc.cu) at the main path's shapes on the card.

    python -m simpb_tpu_torch.tools.conv_tc_sweep [--out FILE]

For each shape, every plan the planner considers
(`bottleneck_down_tc_plans`, `bottleneck_tc_plans`, `conv3x3_tc_plans`
in ops/conv_fused.py) is launched on the same seeded
inputs, checked against the plain version (3e-2 of max(|plain|, 1), the
bf16 tolerance of chip_smoke.py) and timed with CUDA events over 20
back-to-back launches after 3 warm ones. Prints, per shape, the
planner's pick and the five fastest plans; writes every row as a JSON
line to FILE (default chiprun_out/conv_tc_sweep.jsonl). Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..ops import _kernels
from ..ops import conv_fused as cf

# ResNet-50 at 704x256, 6 cameras: (H, W, C, Cm, Co, stride) of each
# stage head's K2 (H, W of its input), (H, W, C, Cm) of each stage's K3
K2_SHAPES = ((64, 176, 64, 64, 256, 1), (64, 176, 256, 128, 512, 2),
             (32, 88, 512, 256, 1024, 2), (16, 44, 1024, 512, 2048, 2))
K3_SHAPES = ((64, 176, 256, 64), (32, 88, 512, 128), (16, 44, 1024, 256),
             (8, 22, 2048, 512))
K4_SHAPES = ((64, 176), (32, 88), (16, 44), (8, 22))
TOL = 3e-2


def _time(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _rows_k2(gen):
    bf = torch.bfloat16
    for h, w, c, cm, co, s in K2_SHAPES:
        rnd = lambda *sh, k=1.0: torch.randn(*sh, generator=gen,
                                             device="cuda") * k
        x = rnd(6, h, w, c).to(bf)
        folded = (rnd(c, cm, k=c ** -0.5).to(bf), rnd(cm) * 0.1,
                  rnd(3, 3, cm, cm, k=(9 * cm) ** -0.5).to(bf),
                  rnd(cm) * 0.1, rnd(cm, co, k=cm ** -0.5).to(bf),
                  rnd(co) * 0.1)
        down = (rnd(c, co, k=c ** -0.5).to(bf), rnd(co) * 0.1)
        ref = cf.bottleneck_plain(x, folded, down, s).float()
        scale = max(ref.abs().max().item(), 1.0)
        pick = cf.plan_bottleneck_down_tc(6, h, w, c, cm, co, s)
        y = torch.empty((6, h // s, w // s, co), dtype=bf, device="cuda")
        for est, plan in cf.bottleneck_down_tc_plans(6, h, w, c, cm, co, s):
            run = lambda: _kernels.check(cf.launch_bottleneck_down_tc(
                x, folded, down, y, s, plan), "sweep")
            y.zero_()
            run()
            err = (y.float() - ref).abs().max().item()
            yield dict(kernel="bottleneck_down", shape=[6, h, w, c], cm=cm,
                       co=co, stride=s, plan=plan._asdict(),
                       estimate_s=est[0], picked=plan == pick,
                       ms=_time(run), max_abs_err=err, ok=err <= TOL * scale)


def _rows_k3(gen):
    for h, w, c, cm in K3_SHAPES:
        rnd = lambda *s, k=1.0: torch.randn(*s, generator=gen,
                                            device="cuda") * k
        x = rnd(6, h, w, c).to(torch.bfloat16)
        bf = torch.bfloat16
        folded = (rnd(c, cm, k=c ** -0.5).to(bf), rnd(cm) * 0.1,
                  rnd(3, 3, cm, cm, k=(9 * cm) ** -0.5).to(bf),
                  rnd(cm) * 0.1, rnd(cm, c, k=cm ** -0.5).to(bf),
                  rnd(c) * 0.1)
        ref = cf.bottleneck_plain(x, folded).float()
        scale = max(ref.abs().max().item(), 1.0)
        pick = cf.plan_bottleneck_tc(6, h, w, c, cm)
        y = torch.empty_like(x)
        for est, plan in cf.bottleneck_tc_plans(6, h, w, c, cm):
            run = lambda: _kernels.check(
                cf.launch_bottleneck_tc(x, folded, y, plan), "sweep")
            run()
            err = (y.float() - ref).abs().max().item()
            yield dict(kernel="bottleneck", shape=[6, h, w, c], cm=cm,
                       plan=plan._asdict(), estimate_s=est[0],
                       picked=plan == pick, ms=_time(run), max_abs_err=err,
                       ok=err <= TOL * scale)


def _rows_k4(gen):
    for h, w in K4_SHAPES:
        x = torch.randn(6, h, w, 256, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k = (torch.randn(3, 3, 256, 256, generator=gen, device="cuda")
             * (9 * 256) ** -0.5).to(torch.bfloat16)
        bias = torch.randn(256, generator=gen, device="cuda") * 0.1
        ref = cf.conv3x3_bias_plain(x, k, bias).float()
        scale = max(ref.abs().max().item(), 1.0)
        pick = cf.plan_conv3x3_tc(6, h, w, 256, 256)
        y = torch.empty_like(x)
        for est, plan in cf.conv3x3_tc_plans(6, h, w, 256, 256):
            run = lambda: _kernels.check(
                cf.launch_conv3x3_tc(x, k, bias, y, plan), "sweep")
            run()
            err = (y.float() - ref).abs().max().item()
            yield dict(kernel="conv3x3_bias", shape=[6, h, w, 256],
                       plan=plan._asdict(), estimate_s=est[0],
                       picked=plan == pick, ms=_time(run), max_abs_err=err,
                       ok=err <= TOL * scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/conv_tc_sweep.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_tc_sweep: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = list(_rows_k2(gen)) + list(_rows_k3(gen)) + list(_rows_k4(gen))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(dict(r, card=card)) + "\n"
                           for r in rows))
    bad = [r for r in rows if not r["ok"]]
    groups = {}
    for r in rows:
        groups.setdefault((r["kernel"], tuple(r["shape"])), []).append(r)
    for key, rs in groups.items():
        rs.sort(key=lambda r: r["ms"])
        pick = next(r for r in rs if r["picked"])
        print(json.dumps(dict(kernel=key[0], shape=list(key[1]),
                              plans=len(rs), picked_ms=pick["ms"],
                              picked=pick["plan"],
                              fastest=[(r["ms"], r["plan"]) for r in rs[:5]])),
              flush=True)
    if bad:
        raise SystemExit(f"conv_tc_sweep: {len(bad)} plans disagree with "
                         f"the plain version: {bad[:3]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
