"""Planted faults against chip_smoke's checks of kernels B, C and D and
of the exact MSDA forward.

    python -m simpb_tpu_torch.tools.planted_faults

`chip_smoke.grad_check` holds the DFA, MSDA-sel and exact MSDA backward
kernels to their plain versions element by element; the exact phase holds
the exact
MSDA kernel to `msda_plain` (`chip_smoke.within`, at EXACT_TOL). To show
that they see a fault that drops a small part of a result, the tool
copies the checkout into `build/planted_faults/<fault>/`, edits one line
of `csrc/sampling.cu` there (`FAULTS`: kernel B's feature-gradient
accumulation in B2, the same owner pass's accumulation in kernel D's D2,
kernel C's value-gradient accumulation in C3, or the exact MSDA kernel's
bilinear sample), builds that copy and runs
chip_smoke's synthetic gradient cases and exact MSDA cases (fp32 and
bf16) on it. It prints one JSON line per (fault, case): whether the
check passes, whether the bound it replaced (`MAX_SCALED`: a share of
the plain gradient's largest value; for exact MSDA the check itself)
passes, and each gradient's worst share of the check's bound; then one
summary line per fault. It exits 1 when the unchanged copy fails a case,
or when a fault passes the check on any case of the kernel it edits
(every case has live entries for each fault to hit: the dead-anchor
cases keep anchor 0 live, and query 0 of every exact case samples the
interior, for the forward and for D). The copies are removed at the end.
Needs the card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WORK = ROOT / "build" / "planted_faults"
_B_ACCUMULATE = "              if (wc != 0.f)\n"
_C_ACCUMULATE = "              acc[p][c] = fmaf(wp[p], gv[c], acc[p][c]);\n"
_EXACT_SAMPLE = "        msda_bilinear<T>(smp, w, corner);\n"
# fault -> (kernel edited, text in csrc/sampling.cu, its replacement)
FAULTS = {
    "none": (None, None, None),
    # kernel B: every entry of anchor 0 drops its fourth corner (B2's
    # warps walk staged entry e, its anchor in sAnc[e], corner k)
    "dfa_corner3_of_anchor0": (
        "deformable_aggregation_backward", _B_ACCUMULATE,
        "              if (wc != 0.f && !(k == 3 && sAnc[e] == 0))\n"),
    # kernel B: feature-gradient contributions below 1e-4 are dropped
    "dfa_small_contributions": (
        "deformable_aggregation_backward", _B_ACCUMULATE,
        "              if (wc != 0.f && fabsf(gg[c] * wc) >= 1e-4f)\n"),
    # kernel D: in D2 (B2's pass over D1's records, EXACT) every sample of
    # query 0, head 0 (its g_sampled row, staged in sAnc[e], is 0) drops
    # its fourth corner
    "msda_exact_bwd_corner3_of_query0": (
        "msda_backward", _B_ACCUMULATE,
        "              if (wc != 0.f && !(EXACT && k == 3 && "
        "sAnc[e] == 0))\n"),
    # kernel C: window pixel 0 of query 0 adds nothing to the value
    # gradient (C3 walks window e = query * K + k; its pixel 0 is the
    # window's base)
    "msda_pixel0_of_query0": (
        "msda_patch_sel_backward", _C_ACCUMULATE,
        "              if (!(e < g.K && tx0 + p == bx && yy == by)) "
        "acc[p][c] = fmaf(wp[p], gv[c], acc[p][c]);\n"),
    # kernel C: value-gradient contributions below 1e-4 are dropped
    "msda_small_contributions": (
        "msda_patch_sel_backward", _C_ACCUMULATE,
        "              if (fabsf(wp[p] * gv[c]) >= 1e-4f) "
        "acc[p][c] = fmaf(wp[p], gv[c], acc[p][c]);\n"),
    # exact MSDA: query 0 of camera row 0 drops the fourth bilinear
    # corner (x1, y1) of every sample (the block bq = 0)
    "msda_exact_corner3_of_query0": (
        "msda", _EXACT_SAMPLE,
        "        if (bq == 0) corner[3].zero();\n" + _EXACT_SAMPLE),
}
MAX_SCALED = {"float32": 1e-5, "bfloat16": 1e-2}


def run_cases() -> None:
    """Run in a copy's root: chip_smoke's synthetic gradient cases, one
    JSON line each."""
    import torch

    sys.path.insert(0, ".")
    import chip_smoke

    from ..ops import sampling

    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(3)
        dname = str(dtype).split(".")[-1]
        for label, args in chip_smoke.exact_cases(torch, dtype, gen):
            got = sampling.msda(*args, raw_heads=True)
            ref = sampling.msda_plain(*args, raw_heads=True)
            ok, errs = chip_smoke.within(got, ref, chip_smoke.EXACT_TOL[dname])
            print(json.dumps(dict(
                case=label, kernel="msda", dtype=dname, passes_check=ok,
                passes_max_scaled=ok, max_abs_err=errs)), flush=True)
    bwd = {n: (w, p) for n, w, p, _ in sampling.BACKWARD_KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, name, args in chip_smoke.grad_cases(torch, sampling, [], gen):
        wrapper, plain = bwd[name]
        got = wrapper(*args)
        ref = plain(*(args[:6] if name.startswith("deformable") else args))
        ok, recs = chip_smoke.grad_check(got, ref)
        scaled = all(
            (g.float() - r.float()).abs().max().item()
            <= MAX_SCALED[str(g.dtype).split(".")[-1]]
            * r.float().abs().max().item()
            for g, r in zip(got, ref))
        print(json.dumps(dict(
            case=label, kernel=name, dtype=str(args[0].dtype).split(".")[-1],
            passes_check=ok, passes_max_scaled=scaled,
            worst_share_of_bound=[r["worst_share_of_bound"] for r in recs])),
            flush=True)


def main() -> int:
    from ..utils.device import resolve_device

    resolve_device(None)  # raises without a card
    bad = False
    try:
        for fault, (kernel, old, new) in FAULTS.items():
            copy = WORK / fault
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                "build", ".git", "__pycache__"))
            if old is not None:
                src = copy / "simpb_tpu_torch" / "csrc" / "sampling.cu"
                text = src.read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{fault}: the line to edit is not "
                                       "in csrc/sampling.cu once")
                src.write_text(text.replace(old, new))
            out = subprocess.run(
                [sys.executable, "-c", "from simpb_tpu_torch.tools."
                 "planted_faults import run_cases; run_cases()"],
                cwd=copy, capture_output=True, text=True, timeout=900)
            if out.returncode:
                raise RuntimeError(f"{fault}: {out.stderr[-3000:]}")
            rows = [json.loads(ln) for ln in out.stdout.splitlines()
                    if ln.startswith("{")]
            for row in rows:
                print(json.dumps(dict(fault=fault, **row)), flush=True)
            mine = [r for r in rows if kernel in (None, r["kernel"])]
            failed = sum(not r["passes_check"] for r in mine)
            summary = dict(
                fault=fault, kernel=kernel, cases=len(mine),
                fail_check=failed,
                fail_max_scaled=sum(not r["passes_max_scaled"] for r in mine))
            print(json.dumps(summary), flush=True)
            bad = bad or (failed > 0 if kernel is None
                          else failed < len(mine))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
