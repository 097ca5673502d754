"""Planted faults against chip_smoke's checks of kernels B, C and D, of
the exact MSDA forward and of the hybrid's kernels H1, H2 and H3.

    python -m simpb_tpu_torch.tools.planted_faults

`chip_smoke.grad_check` holds the DFA, MSDA-sel and exact MSDA backward
kernels to their plain versions element by element; the exact phase holds
the exact MSDA kernel to `msda_plain` (`chip_smoke.within`, at
EXACT_TOL); the hybrid phase holds H1 to its plain version at MSDA-sel's
tolerance, H2 at EXACT_TOL and H3 bit for bit (`chip_smoke.within` at
`HYBRID_TOL`).
To show that they see a fault that drops a small part of a result, the
tool copies the checkout into `build/planted_faults/<fault>/`, edits a
line of `csrc/sampling.cu` there (`FAULTS`: kernel B's feature-gradient
accumulation in B2, kernel D's records as D1 writes them, kernel D's bin
pass (a tile list that loses its last record), kernel C's value-gradient
accumulation in C3, the exact MSDA kernel's corner rows, H1's last level
of query 0 (one line in each of its two kernels, fp32 and bf16), H2's
last corrected level of query 0, H2's walk skipping query 0, the
zeroing of H3's op instance for a row's entry 0, or the count of H3's
guards' instance for query 0), builds
that copy and runs chip_smoke's synthetic gradient cases, exact MSDA
cases and hybrid cases (fp32 and bf16) on it. It prints one JSON
line per (fault, case): whether the check passes, whether the bound it
replaced (`MAX_SCALED`: a share of the plain gradient's largest value;
for exact MSDA the check itself) passes, and each gradient's worst share
of the check's bound; then one summary line per fault. It exits 1 when
the unchanged copy fails a case, or when a fault passes the check on any
case of the kernel it edits (every case has live entries for each fault
to hit: the dead-anchor cases keep anchor 0 live, query 0 of every
exact case samples the interior, for the forward and for D, and query 0
of every hybrid case has a clamped level 0, a corrected entry and
weight on its last level). The copies are removed at the end. Needs the
card.
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
_D_RECORD = "    rwk[ri] = wk;\n"
_D_LIST = "    tc[t] = e - s;\n"
_EXACT_CORNERS = "            if (ld) dfa_corners(vl, w, r, g.C, v[u][i]);\n"
_H1_FP32 = ("          if (hh < g.heads) "
            "acc[hh] = fmaf(Wj[hh * win + e], v, acc[hh]);\n")
_H1_LEVELS = "    if (live) {  // the level's product on the tensor cores\n"
_H2_LEVELS = ("            lacc[i][c] = __fadd_rn(lacc[i][c], "
              "__fmul_rn(smp[c], am.x));\n")
_H2_WALK = "  if (!S) return;\n"
_H3_SELECT = "    if (taken) {\n"
_H3_DEMAND = "    if (!valid || valid[q0 + q]) {\n"
# fault -> (kernel edited, text in csrc/sampling.cu, its replacement); a
# fault of a kernel with two instances edits a tuple of lines, one each
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
    # kernel D: D1 writes every sample record of query 0, head 0 (item
    # bqh % (Q heads) == 0 of each camera row) with its fourth corner's
    # weight 0, so D2 drops that corner
    "msda_exact_bwd_corner3_of_query0": (
        "msda_backward", _D_RECORD,
        "    if (bqh % qh) rwk[ri] = wk; "
        "else rwk[ri] = make_float4(wk.x, wk.y, wk.z, 0.f);\n"),
    # kernel D: the bin pass's scan shortens every tile's list by one,
    # so D2 never sums the last record of a tile
    "msda_exact_bwd_list_loses_last_record": (
        "msda_backward", _D_LIST,
        "    if (e > s) tc[t] = e - s - 1; else tc[t] = 0;\n"),
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
    # exact MSDA: query 0 of camera row 0 (its heads' items, bqh < heads)
    # drops the fourth bilinear corner (x1, y1) of every sample
    "msda_exact_corner3_of_query0": (
        "msda", _EXACT_CORNERS,
        "            if (ld) { dfa_corners(vl, w, r, g.C, v[u][i]); "
        "if (bqh < g.heads) v[u][i][3].zero(); }\n"),
    # H1: query 0 of camera row 0 leaves its last level out of the
    # windowed sums (fp32: block (0, 0) of msda_sel_kernel; bf16: the
    # ring kernel's product of item (query 0, last level))
    "msda_patch_levels_last_level_of_query0": (
        "msda_patch_levels", (_H1_FP32, _H1_LEVELS), (
            "          if (hh < g.heads && !(K == L && q == 0 && b == 0 && "
            "j == K - 1)) acc[hh] = fmaf(Wj[hh * win + e], v, acc[hh]);\n",
            "    if (live && (bq || l < L - 1)) {  // the level's product on "
            "the tensor cores\n")),
    # H2: query 0 of camera row 0 (its heads' items, bqh < heads) leaves
    # the samples of its last marked level (the walk's last P) out of its
    # sums
    "msda_hybrid_exact_drops_last_level_of_query0": (
        "msda_hybrid_exact", _H2_LEVELS,
        "            if (bqh >= g.heads || s0 + t < S - g.P) lacc[i][c] = "
        "__fadd_rn(lacc[i][c], __fmul_rn(smp[c], am.x));\n"),
    # H2's walk: the half-warps that hold query 0 of camera row 0 skip it
    # as if it had no marked level
    "msda_hybrid_exact_walk_skips_query0": (
        "msda_hybrid_exact", _H2_WALK,
        "  if (!S || bqh < g.heads) return;\n"),
    # H3, the op's instance: a camera row's corrected entry 0 (query 0,
    # level 0) keeps its weights in the windowed lane
    "clamp_select_entry0_keeps_weights": (
        "clamp_select", _H3_SELECT, "    if (taken && e) {\n"),
    # H3, the guards' instance: query 0 of camera row 0 is not counted
    "clamp_demand_skips_query0": (
        "clamp_demand", _H3_DEMAND,
        "    if ((!valid || valid[q0 + q]) && (q || blockIdx.x)) {\n"),
}
MAX_SCALED = {"float32": 1e-5, "bfloat16": 1e-2}


def edits(old, new):
    """A fault's (line, replacement) pairs: one, or a tuple of each."""
    return list(zip(old, new)) if isinstance(old, tuple) else [(old, new)]


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
        for label, name, args in chip_smoke.hybrid_cases(torch, dtype, gen):
            wrapper, plain = chip_smoke.hybrid_wrappers()[name]
            got, ref = wrapper(*args), plain(*args)
            ok, errs = chip_smoke.within(
                got if isinstance(got, tuple) else (got,),
                ref if isinstance(ref, tuple) else (ref,),
                chip_smoke.HYBRID_TOL[name])
            print(json.dumps(dict(
                case=label, kernel=name, dtype=dname, passes_check=ok,
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
                for o, n in edits(old, new):
                    if text.count(o) != 1:
                        raise RuntimeError(f"{fault}: a line to edit is not "
                                           "in csrc/sampling.cu once")
                    text = text.replace(o, n)
                src.write_text(text)
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
