#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env     — the card (nvidia-smi name and power limit), torch and CUDA
             versions; TF32 off for the whole run.
2. build   — compiles simpb_tpu_torch/csrc/*.cu with nvcc for sm_90a.
3. kernels — each trunk kernel (K1 max-pool, K2 downsample bottleneck,
             K3 bottleneck, K4 3x3 conv) against its plain PyTorch
             version at every full-width shape of the main path, fp32
             and bf16, with its time (CUDA events, warm), the plain
             version's, the cuDNN call computing the same function where
             one exists (timed only), and the least time the card could
             take (bytes over 3.35 TB/s or operations over the peak rate
             of the type, published H100 SXM figures).
4. slice   — the main path: `simpb_r50_704x256_fast` with the fused trunk
             at full width (ResNet-50, 704x256, 6 cameras, 900 anchors,
             600 temporal instances), trunk bf16, head fp32, seeded
             random weights; one cold frame and FRAMES (8) stream frames.
             Launch counts must be K1 1, K2 4, K3 12, K4 4 per frame.
             Prints each frame's ms, the trunk's ms alone and the peak
             device memory.
5. parity  — the same slice in fp32 once through the kernels and once
             through their plain versions; head outputs compared.

Then the kernels' summary line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0). With
no CUDA device, or outside the repository, it exits 2 and prints no
result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, per second
# per-call error bound, relative to max |plain| (at least 1): fp32 sums
# run in another order than cuDNN's; bf16 intermediates (y1, y2) round
# to the storage type, where one ulp is 2^-8 of the value
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# whole-slice fp32 parity (kernels vs plain versions): sum order through
# 16 blocks and 6 decoder layers; the CPU parity of the tiny slice with
# the JAX package holds 5e-4 (tests/test_torch_port_slice.py)
SLICE_ATOL, SLICE_RTOL = 2e-3, 2e-3
FRAMES = 8  # stream frames after the cold frame

# ResNet-50 stages at 704x256: (mid channels, out channels, output H, W,
# stride of the stage head, blocks)
STAGES = ((64, 256, 64, 176, 1, 3), (128, 512, 32, 88, 2, 4),
          (256, 1024, 16, 44, 2, 6), (512, 2048, 8, 22, 2, 3))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(2):
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


def kernel_cases():
    """(name, calls per frame, shapes) for every distinct full-width
    call of the main path, and an odd-sized max-pool (no call a frame)."""
    cases = [("maxpool_3x3_s2", 1, dict(x=(6, 128, 352, 64))),
             ("maxpool_3x3_s2", 0, dict(x=(6, 127, 351, 64)))]
    cin = 64
    for cm, co, h, w, s, n in STAGES:
        hin, win = h * s, w * s
        cases.append(("bottleneck_down", 1, dict(
            x=(6, hin, win, cin), c=cin, cm=cm, co=co, stride=s)))
        cases.append(("bottleneck", n - 1, dict(
            x=(6, h, w, co), c=co, cm=cm, co=co, stride=1)))
        cases.append(("conv3x3_bias", 1, dict(x=(6, h, w, 256), c=256,
                                              co=256)))
        cin = co
    return cases


def make_inputs(case, dtype, gen):
    import torch

    dev = "cuda"
    rnd = lambda *s, scale=1.0: torch.randn(
        *s, generator=gen, device=dev) * scale
    name, _, a = case
    x = rnd(*a["x"]).to(dtype).contiguous()
    if name == "maxpool_3x3_s2":
        return (x,)
    if name == "conv3x3_bias":
        c, co = a["c"], a["co"]
        return (x, rnd(3, 3, c, co, scale=(9 * c) ** -0.5), rnd(co) * 0.1)
    c, cm, co = a["c"], a["cm"], a["co"]
    folded = (rnd(c, cm, scale=c ** -0.5), rnd(cm) * 0.1,
              rnd(3, 3, cm, cm, scale=(9 * cm) ** -0.5), rnd(cm) * 0.1,
              rnd(cm, co, scale=cm ** -0.5), rnd(co) * 0.1)
    folded = tuple(t.to(dtype) if t.dim() > 1 else t for t in folded)
    if name == "bottleneck":
        return (x, folded)
    down = (rnd(c, co, scale=c ** -0.5).to(dtype), rnd(co) * 0.1)
    return (x, folded, down, a["stride"])


def work(case, itemsize):
    """(bytes, operations) the call must move and do at least: each
    input read once, each output written once."""
    name, _, a = case
    b, h, w, c = a["x"]
    if name == "maxpool_3x3_s2":
        n_out = b * ((h + 1) // 2) * ((w + 1) // 2) * c
        return (b * h * w * c + n_out) * itemsize, 8 * n_out
    if name == "conv3x3_bias":
        co = a["co"]
        macs = b * h * w * 9 * c * co
        byts = (b * h * w * (c + co) + 9 * c * co) * itemsize + 4 * co
        return byts, 2 * macs
    cm, co, s = a["cm"], a["co"], a["stride"]
    oh, ow = h // s, w // s
    macs = b * (h * w * c * cm + oh * ow * (9 * cm * cm + cm * co))
    wts = c * cm + 9 * cm * cm + cm * co
    if name == "bottleneck_down":
        macs += b * oh * ow * c * co
        wts += c * co
    byts = (b * h * w * c + b * oh * ow * co + wts) * itemsize \
        + 4 * (2 * cm + 2 * co)
    return byts, 2 * macs


def library_call(case, args):
    """The one PyTorch call computing the same function (cuDNN), timed
    as a yardstick only; None where no single call does."""
    import torch.nn.functional as F

    name = case[0]
    if name == "maxpool_3x3_s2":
        x = args[0].permute(0, 3, 1, 2)
        return lambda: F.max_pool2d(x, 3, 2, 1)
    if name == "conv3x3_bias":
        x, k, bias = args
        xc = x.permute(0, 3, 1, 2)
        wc = k.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        bc = bias.to(x.dtype)
        return lambda: F.conv2d(xc, wc, bc, padding=1)
    return None


def phase_kernels(torch, conv_fused):
    gen = torch.Generator(device="cuda").manual_seed(0)
    wrappers = {n: (w, p, tpu) for n, w, p, tpu in conv_fused.KERNELS}
    # per kernel, over a frame's calls at bf16 (the main path's type);
    # `bound` sums each call's bound by what bounds that call
    summary = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bound={"bytes": 0.0, "operations": 0.0})
               for n in wrappers}
    for case in kernel_cases():
        name, count, a = case
        wrapper, plain, _ = wrappers[name]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = make_inputs(case, dtype, gen)
            got = wrapper(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                                     f"{ref.shape}/{ref.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = max(ref.float().abs().max().item(), 1.0)
            ok = err <= TOL[dname] * scale
            ms = cuda_ms(lambda: wrapper(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            lib = library_call(case, args)
            lib_ms = cuda_ms(lib) if lib is not None else None
            byts, ops = work(case, args[0].element_size())
            b_ms = byts / PEAK_BYTES * 1e3
            o_ms = ops / PEAK_OPS[dname] * 1e3
            bound_by = "bytes" if b_ms >= o_ms else "operations"
            emit(dict(phase="kernel", name=name, dtype=dname,
                      shape=list(a["x"]), per_frame=count,
                      max_abs_err=err, tol=TOL[dname] * scale, ok=ok,
                      ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=max(b_ms, o_ms), bound_by=bound_by))
            if not ok:
                raise AssertionError(f"{name} {dname} {a['x']}: max abs err "
                                     f"{err} > {TOL[dname] * scale}")
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if dtype == torch.bfloat16:  # the main path's type
                s["ms"] += count * ms
                s["plain_ms"] += count * plain_ms
                s["bound"][bound_by] += count * max(b_ms, o_ms)
                s["library_ms"] = (None if lib_ms is None or
                                   s["library_ms"] is None else
                                   s["library_ms"] + count * lib_ms)
            del args, got, ref
    return summary, wrappers


def stream_inputs(torch, cfg, frames, seed=0):
    import numpy as np

    from simpb_tpu_torch.utils.synthetic import synthetic_rig

    w, h = cfg.input_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs = [torch.randn(1, 6, h, w, 3, generator=gen, device="cuda")
            for _ in range(frames + 1)]
    proj = torch.from_numpy(synthetic_rig(1, (w, h))).cuda()
    t2c = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.02), np.sin(0.02)
    t2c[:2, :2] = [[c, -s], [s, c]]
    t2c[:2, 3] = [0.1, 2.0]  # ~4 m/s forward at 0.5 s a frame
    return imgs, proj, torch.from_numpy(t2c)[None].cuda(), \
        torch.full((1,), 0.5, device="cuda")


def run_stream(torch, model, cfg, frames):
    """Cold frame + `frames` stream frames; returns (decoded list,
    per-frame ms, per-frame launch counts)."""
    from simpb_tpu_torch.ops import conv_fused
    from simpb_tpu_torch.training.evaluate import make_stream_steps

    cold, stream = make_stream_steps(model, cfg)
    imgs, proj, t2c, dt = stream_inputs(torch, cfg, frames)
    decs, times, counts = [], [], []
    state = None
    for f, img in enumerate(imgs):
        before = conv_fused.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if f == 0:
            dec, state = cold(img, proj)
        else:
            dec, state = stream(img, proj, state, dt, t2c)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        after = conv_fused.launch_counts()
        counts.append({k: after[k] - before[k] for k in after})
        decs.append(dec)
    return decs, times, counts


def check_stream(torch, decs):
    prev_ids = None
    carried = 0
    for f, d in enumerate(decs):
        for k in ("boxes_3d", "scores_3d", "cls_scores"):
            if not torch.isfinite(d[k]).all():
                raise AssertionError(f"frame {f}: non-finite {k}")
        s = d["scores_3d"][0]
        if not (s[:-1] >= s[1:]).all():
            raise AssertionError(f"frame {f}: scores not sorted")
        ids = set(d["instance_ids"][0][d["valid"][0]].tolist()) - {-1}
        if prev_ids is not None:
            carried = len(ids & prev_ids)
        prev_ids = ids
    if carried == 0:
        raise AssertionError("no instance id carried into the last frame")
    return carried


def phase_slice(torch, frames):
    import dataclasses

    from simpb_tpu_torch.configs.base import simpb_r50_704x256_fast
    from simpb_tpu_torch.ops import conv_fused
    from simpb_tpu_torch.training.evaluate import build_model

    cfg = dataclasses.replace(simpb_r50_704x256_fast(),
                              backbone_fused_infer=True,
                              compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    conv_fused.reset_launch_counts()
    decs, times, counts = run_stream(torch, model, cfg, frames)
    launches = conv_fused.launch_counts()
    want = {"maxpool_3x3_s2": 1, "bottleneck_down": 4, "bottleneck": 12,
            "conv3x3_bias": 4}
    for f, c in enumerate(counts):
        if c != want:
            raise AssertionError(f"frame {f}: launches {c}, want {want}")
    carried = check_stream(torch, decs)
    peak = torch.cuda.max_memory_allocated()
    # the trunk alone (stem, kernels, FPN; CUDA events): the rest of a
    # stream frame is the head, the decode and the host between them
    w, h = cfg.input_size
    img = torch.randn(1, 6, h, w, 3, device="cuda")
    with torch.inference_mode():
        trunk_ms = cuda_ms(lambda: model.extract_feat(img), iters=5)
    d = decs[-1]
    emit(dict(phase="slice", config="simpb_r50_704x256_fast",
              backbone_fused_infer=True, trunk="bfloat16", head="float32",
              frames=len(decs), frame_ms=times, trunk_ms=trunk_ms,
              max_memory_allocated=peak,
              launches=launches, launches_per_frame=counts[-1],
              ids_carried_last_frame=carried,
              valid_last_frame=int(d["valid"].sum().item()),
              top_score_last_frame=float(d["scores_3d"][0, 0].item())))
    del model
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def plain_trunk():
    """Route the trunk through the kernels' plain versions (the parity
    reference); the wrappers themselves never do that on the card."""
    from simpb_tpu_torch.models import backbone
    from simpb_tpu_torch.ops import conv_fused

    names = {
        "maxpool_3x3_s2_fused": conv_fused.maxpool_3x3_s2_plain,
        "bottleneck_down_fused_infer": conv_fused.bottleneck_plain,
        "bottleneck_fused_infer": conv_fused.bottleneck_plain,
        "conv3x3_bias_fused": conv_fused.conv3x3_bias_plain,
    }
    saved = {n: getattr(backbone, n) for n in names}
    try:
        for n, fn in names.items():
            setattr(backbone, n, fn)
        yield
    finally:
        for n, fn in saved.items():
            setattr(backbone, n, fn)


def phase_parity(torch):
    import dataclasses

    from simpb_tpu_torch.configs.base import simpb_r50_704x256_fast
    from simpb_tpu_torch.training.evaluate import build_model

    cfg = dataclasses.replace(simpb_r50_704x256_fast(),
                              backbone_fused_infer=True,
                              compute_dtype="float32")
    model = build_model(cfg, device="cuda", seed=0)
    outs = {}
    for route in ("kernels", "plain"):
        ctx = plain_trunk() if route == "plain" else contextlib.nullcontext()
        with ctx, torch.inference_mode():
            imgs, proj, _, _ = stream_inputs(torch, cfg, 0)
            outs[route] = model(imgs[0], proj)
    errs = {}
    for key in ("prediction", "classification", "quality"):
        k_t, p_t = outs["kernels"][key][-1], outs["plain"][key][-1]
        diff = (k_t - p_t).abs()
        errs[key] = diff.max().item()
        bound = SLICE_ATOL + SLICE_RTOL * p_t.abs()
        if not (diff <= bound).all():
            raise AssertionError(f"parity {key}: max abs err {errs[key]}")
    emit(dict(phase="parity", config="simpb_r50_704x256_fast", dtype="fp32",
              tf32=False, atol=SLICE_ATOL, rtol=SLICE_RTOL, max_abs_err=errs))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from simpb_tpu_torch.ops import _kernels, conv_fused
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(dict(phase="env", card=card, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), tf32=False))

    t0 = time.perf_counter()
    lib = _kernels.build("conv_fused")
    log = _kernels.BUILD_DIR / "conv_fused.ptxas.txt"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=str(lib.relative_to(_kernels.PKG_DIR.parent)),
              ptxas=ptxas))

    summary, wrappers = phase_kernels(torch, conv_fused)
    launches = phase_slice(torch, FRAMES)
    phase_parity(torch)

    kernels = []
    for name, s in summary.items():
        kernels.append(dict(
            name=name, route="cuda",
            source="simpb_tpu_torch/csrc/conv_fused.cu",
            replaces=wrappers[name][2], launches=launches[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"],
            bound_ms=sum(s["bound"].values()),
            bound_by=max(s["bound"], key=s["bound"].get),
            library_ms=s["library_ms"],
        ))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
