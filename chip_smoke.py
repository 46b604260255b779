#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vae_segmentation_tpu_torch) on one NVIDIA
GPU and check it. Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--cases 3] [--out PATH]

Phases, each printed as JSON records:
  1. card: ``nvidia-smi`` name and power limit; the kernels' nvcc build.
  2. kernels: one Joint forward of the main path runs through the plain
     PyTorch versions (f32 math, TF32 off) with hooks recording every
     kernel-backed call (58 + 9 + 9). Each call's kernel then runs on that
     call's recorded inputs against its recorded plain output: y max abs
     err <= 1e-2 * max|y| (softmax probabilities <= 1e-2 abs), stats sum
     err <= 1e-3 * sum|y| and sumsq rel err <= 1e-3 (atomics add in a
     varying order). Each distinct (kernel, shape, options) is timed beside
     the plain version and one cuDNN call (bf16, channels_last_3d; a
     yardstick only, the port never calls it). ``bound_ms`` is the larger
     of the bytes over 3.35 TB/s and the operations over 989 TFLOP/s (bf16).
  3. main path: synthetic cases (from --seed) and a seed-initialised
     full-width Joint saved as a port checkpoint, then the port's target CLI
     ``--test_only`` at 128^3 on cuda. Checks: score JSON, each Dice in
     [0, 1], launches 58 / 9 / 9 per Joint forward, and the whole Joint
     forward with kernels against the plain path on the card: finite
     outputs of the expected shapes, Dice within 0.01, and the mean abs
     difference of the probabilities (pred and recon) within
     ``DRIFT_MULTIPLE`` times the drift of the plain path from itself when
     only the f32 summation order of its convs changes.
  4. profile: device time by kernel family over a few forwards
     (``torch.profiler``) and the device's busy share of the forward.
  5. the ``kernels`` line, then the last line
     ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero without the last line. Without a CUDA GPU
it exits 2 and prints no result. All records also go to --out (JSON,
default smoke_out/chip_smoke.json).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
from contextlib import ExitStack, contextmanager
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
PER_FORWARD = {"conv3": 58, "down_k2s2": 9, "up_k2s2": 9}
# kernel-vs-plain mean abs difference of the Joint's probabilities, over the
# plain path's drift from itself under reordered f32 sums
DRIFT_MULTIPLE = 4.0
SOURCES = {
    "conv3": ("vae_segmentation_tpu_torch/ops/kernels/csrc/conv3.cu",
              "vae_segmentation_tpu/ops/pallas/stencil3.py:528 "
              "(_run_conv_grouped); vae_segmentation_tpu/ops/pallas/"
              "stencil3.py:692 (_run_conv)"),
    "down_k2s2": ("vae_segmentation_tpu_torch/ops/kernels/csrc/bridge.cu",
                  "vae_segmentation_tpu/ops/pallas/upbridge.py:326 "
                  "(_run_down_fwd); vae_segmentation_tpu/ops/pallas/"
                  "upbridge.py:533 (_run_down_fwd_pre)"),
    "up_k2s2": ("vae_segmentation_tpu_torch/ops/kernels/csrc/bridge.cu",
                "vae_segmentation_tpu/ops/pallas/upbridge.py:119 (_run_fwd)"),
}


def emit(record: dict, log: list) -> None:
    log.append(record)
    print(json.dumps(record), flush=True)


def cuda_ms(torch, fn, budget_ms: float = 40.0, max_reps: int = 50) -> float:
    """Mean device time of fn() over repeated launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(max(budget_ms / one, 3), max_reps))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def work_of(name: str, shape, cin: int, cout: int, pre: bool,
            stats: bool) -> tuple:
    """(bytes, flops) the call must move / do: each input read once, each
    output written once; bf16 activations and weights, f32 bias/affine."""
    b, d, h, w = shape[:4]
    n_in = b * d * h * w
    if name == "conv3":
        n_out, taps, macs = n_in, 27, 27 * cin * cout
    elif name == "down_k2s2":
        n_out, taps, macs = n_in // 8, 8, 8 * cin * cout
    else:
        n_out, taps, macs = n_in * 8, 8, cin * cout
    nbytes = (2 * n_in * cin + 2 * taps * cin * cout + 4 * cout
              + (8 * b * cin if pre else 0) + 2 * n_out * cout
              + (8 * b * cout if stats else 0))
    return nbytes, 2 * n_out * macs


def kernel_modules() -> dict:
    """Module class -> the kernel it launches."""
    from vae_segmentation_tpu_torch.models.blocks import (
        Conv3, DownConv, TConv2)

    return {Conv3: "conv3", DownConv: "down_k2s2", TConv2: "up_k2s2"}


def _split_sums(fn, F):
    """`fn` (conv3d or conv_transpose3d, NCDHW) as the sum of two convs over
    the halves of the input channels: the same function with another f32
    summation order."""
    def run(x, w, b=None, **kw):
        h = x.shape[1] // 2
        if h == 0:
            return fn(x, w, b, **kw)
        wa, wb = (w[:, :h], w[:, h:]) if fn is F.conv3d else (w[:h], w[h:])
        return fn(x[:, :h], wa, b, **kw) + fn(x[:, h:], wb, None, **kw)
    return run


@contextmanager
def plain_ops(reordered: bool = False):
    """Within: every kernel wrapper the models call runs its plain PyTorch
    version instead (f32 math on the same bf16 values). reordered=True
    also splits each plain conv's input channels in two halves: the plain
    path with another f32 summation order."""
    import torch.nn.functional as F

    from vae_segmentation_tpu_torch.ops import bridges, conv3

    def drop_kweight(plain):
        return lambda x, w, b, kweight=None, *rest: plain(x, w, b, *rest)

    with ExitStack() as stack:
        for mod, name, plain in ((conv3, "conv3", conv3.conv3_plain),
                                 (bridges, "down_k2s2",
                                  bridges.down_k2s2_plain),
                                 (bridges, "up_k2s2", bridges.up_k2s2_plain)):
            stack.enter_context(
                mock.patch.object(mod, name, drop_kweight(plain)))
        if reordered:
            ns = types.SimpleNamespace(
                conv3d=_split_sums(F.conv3d, F),
                conv_transpose3d=_split_sums(F.conv_transpose3d, F))
            for mod in (conv3, bridges):
                stack.enter_context(mock.patch.object(mod, "F", ns))
        yield


def record_calls(torch, model, image):
    """One Joint forward through the PLAIN path with hooks on every
    kernel-backed module: a list, in launch order, of each call's key
    (kernel, input shape, options, Cout), module, inputs and plain
    outputs."""
    names = kernel_modules()
    calls = []

    def hook(module, args, kwargs, out):
        a = inspect.signature(module.forward).bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        name = names[type(module)]
        cout = module.weight.shape[1 if name == "up_k2s2" else 0]
        calls.append({
            "key": (name, tuple(a["x"].shape), a.get("pre") is not None,
                    bool(a.get("stats")), bool(a.get("softmax")), cout),
            "module": module, "x": a["x"], "pre": a.get("pre"), "out": out})

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules() if type(m) in names]
    try:
        with torch.no_grad(), plain_ops():
            model(image)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return calls


def _fns(torch, name, m, x, pre, stats, softmax):
    """(kernel, plain, library) callables of one recorded call."""
    import torch.nn.functional as F

    from vae_segmentation_tpu_torch.ops import bridges, conv3

    w, b, kw = m.weight, m.bias, m._kw
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    bl = b.to(torch.bfloat16)
    xl = x.permute(0, 4, 1, 2, 3)  # NDHWC data seen as channels_last_3d
    if name == "conv3":
        return (lambda: conv3.conv3(x, w, b, kw, pre, stats, softmax),
                lambda: conv3.conv3_plain(x, w, b, pre, stats, softmax),
                lambda: F.conv3d(xl, wl, bl, padding=1))
    if name == "down_k2s2":
        return (lambda: bridges.down_k2s2(x, w, b, kw, pre),
                lambda: bridges.down_k2s2_plain(x, w, b, pre),
                lambda: F.conv3d(xl, wl, bl, stride=2))
    return (lambda: bridges.up_k2s2(x, w, b, kw),
            lambda: bridges.up_k2s2_plain(x, w, b),
            lambda: F.conv_transpose3d(xl, wl, bl, stride=2))


def _compare(torch, name, softmax, got, want):
    """Errors of one kernel call against the plain output, and whether
    they are inside the stated tolerances."""
    stats = isinstance(want, tuple)
    yk, yp = (got[0], want[0]) if stats else (got, want)
    err = (yk.float() - yp.float()).abs().max().item()
    scale = yp.float().abs().max().item()
    rec = {"max_abs_err": err, "max_abs_y": scale}
    ok = err <= (1e-2 if softmax else 1e-2 * scale)
    if stats:
        sk, sp = got[1], want[1]
        abs_sum = yp.float().abs().sum(dim=(1, 2, 3))
        rec["stats_sum_err"] = ((sk[:, 0] - sp[:, 0]).abs()
                                / abs_sum).max().item()
        rec["stats_sumsq_rel"] = ((sk[:, 1] - sp[:, 1]).abs()
                                  / sp[:, 1].clamp_min(1e-30)).max().item()
        ok = ok and rec["stats_sum_err"] <= 1e-3 \
            and rec["stats_sumsq_rel"] <= 1e-3
    rec["ok"] = ok
    return rec


def check_kernel_calls(torch, calls, log, failures) -> dict:
    """Phase 2: every call of the recorded forward, kernel on the plain
    path's inputs vs the plain path's outputs; each distinct key also
    timed (kernel, plain, cuDNN) and bounded."""
    keys = {}
    for c in calls:
        name, shape, has_pre, stats, softmax, cout = c["key"]
        kern, _, _ = _fns(torch, name, c["module"], c["x"], c["pre"], stats,
                          softmax)
        with torch.no_grad():
            rec = _compare(torch, name, softmax, kern(), c["out"])
        k = keys.setdefault(c["key"], {"count": 0, "first": c, "err": 0.0,
                                       "ok": True, "worst": rec})
        k["count"] += 1
        k["ok"] = k["ok"] and rec["ok"]
        if rec["max_abs_err"] >= k["err"]:
            k["err"], k["worst"] = rec["max_abs_err"], rec
    torch.cuda.synchronize()

    totals = {}
    for key, k in keys.items():
        name, shape, has_pre, stats, softmax, cout = key
        c = k["first"]
        kern, plain, library = _fns(torch, name, c["module"], c["x"],
                                    c["pre"], stats, softmax)
        rec = {"phase": "kernel", "kernel": name, "shape": list(shape),
               "cin": shape[-1], "cout": cout, "pre": has_pre,
               "stats": stats, "softmax": softmax,
               "calls_per_forward": k["count"], **k["worst"],
               "ok": k["ok"]}
        with torch.no_grad():
            rec["kernel_ms"] = cuda_ms(torch, kern)
            rec["plain_ms"] = cuda_ms(torch, plain, budget_ms=20.0,
                                      max_reps=10)
            rec["library_ms"] = cuda_ms(torch, library)
        nbytes, flops = work_of(name, shape, shape[-1], cout, has_pre, stats)
        rec["bytes"], rec["flops"] = nbytes, flops
        rec["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                    flops / BF16_FLOPS_PER_S)
        emit(rec, log)
        if not rec["ok"]:
            failures.append(f"{name} {shape} disagrees with its plain version")
        t = totals.setdefault(name, dict(err=0.0, kernel_ms=0.0,
                                         plain_ms=0.0, library_ms=0.0,
                                         bound_ms=0.0, bytes_ms=0.0,
                                         ops_ms=0.0, calls=0))
        n = k["count"]
        t["err"] = max(t["err"], rec["max_abs_err"])
        t["calls"] += n
        for f in ("kernel_ms", "plain_ms", "library_ms", "bound_ms"):
            t[f] += n * rec[f]
        t["bytes_ms"] += n * 1e3 * nbytes / HBM_BYTES_PER_S
        t["ops_ms"] += n * 1e3 * flops / BF16_FLOPS_PER_S
    return totals


def divergence(torch, model, image, calls) -> list:
    """[module, max abs, mean abs] difference of each call's output on the
    kernel path from the same call's output on the plain path (phase 2's
    recording), in launch order: how the two paths drift apart."""
    names = {m: n for n, m in model.named_modules()}
    outs = []
    handles = [m.register_forward_hook(lambda mod, a, o: outs.append(o))
               for m in model.modules() if type(m) in kernel_modules()]
    try:
        with torch.no_grad():
            model(image)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    rows = []
    for c, o in zip(calls, outs):
        yk = o[0] if isinstance(o, tuple) else o
        yp = c["out"][0] if isinstance(c["out"], tuple) else c["out"]
        d = (yk.float() - yp.float()).abs()
        rows.append([names[c["module"]], d.max().item(), d.mean().item()])
    return rows


def forward_ms(torch, model, image, reps: int = 5) -> float:
    """Median host-clock time of one synchronised Joint forward."""
    times = []
    with torch.no_grad():
        model(image)
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            model(image)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def _family(name: str) -> str:
    for kernel, family in (("conv3", "conv3"), ("down", "down_k2s2"),
                           ("up", "up_k2s2")):
        if re.search(rf"\b{kernel}_kernel\b", name):
            return family
    # cuBLAS on Hopper names its GEMMs nvjet_*
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "cutlass")):
        return "gemm"
    return "other"


def profile_forward(torch, model, image, reps: int = 5) -> dict:
    """Phase 4: device ms per forward by kernel family (kernel events of
    ``torch.profiler``), host-clock wall ms per forward, and their ratio,
    the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model(image)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(image)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    by_family, other = {}, []
    for ev in prof.key_averages():
        # kernels only: a CPU op's device time repeats its kernels'
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        ms = ev.self_device_time_total / 1e3 / reps
        f = _family(ev.key)
        by_family[f] = by_family.get(f, 0.0) + ms
        if f == "other":
            other.append([ms, ev.key[:80]])
    device_ms = sum(by_family.values())
    return {"phase": "profile", "reps": reps, "wall_ms": wall_ms,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "device_ms_by_family": by_family,
            "largest_other": sorted(other, reverse=True)[:5]}


def _mean_abs(a, b) -> float:
    return (a.float() - b.float()).abs().mean().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("smoke_out",
                                                  "chip_smoke.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vae_segmentation_tpu_torch import ops
    from vae_segmentation_tpu_torch.cli import target_main
    from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
    from vae_segmentation_tpu_torch.data.pipeline import (
        CaseDataset, intensity_normalize)
    from vae_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)
    from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
    from vae_segmentation_tpu_torch.models import Joint
    from vae_segmentation_tpu_torch.ops import losses as L
    from vae_segmentation_tpu_torch.ops.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log, failures = [], []
    t_start = time.time()

    # ---- 1. card and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    build_logs = build.build_all()
    build_s = time.time() - t0
    regs = {n: [ln.split("Used ")[1] for ln in out.splitlines()
                if "Used " in ln] for n, out in build_logs.items()}
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": regs}, log)

    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        # ---- data + model (shared by phases 2 and 3)
        data = os.path.join(work, "data")
        manifest = write_synthetic_dataset(data, n_train=0,
                                           n_val=args.cases, size=128,
                                           seed=args.seed)
        model = Joint(n_class=2, dim=128, bottleneck=16384,
                      generator=torch.Generator().manual_seed(args.seed))
        save_checkpoint(os.path.join(work, "3dmodel", "smoke",
                                     "best_model.ckpt"),
                        epoch=0, model=model)
        model = model.to("cuda").eval()
        with open(manifest) as f:
            entries = json.load(f)["NIH_val"]
        case = CaseDataset(entries, data, parse_pan_index("1"))[0]
        image = intensity_normalize(
            torch.from_numpy(case["image"]).cuda())[None, ..., None]
        label = torch.from_numpy(case["label"]).cuda()[None]

        # ---- 2. every kernel at every main-path shape
        calls = record_calls(torch, model, image)
        per_fwd = {}
        for c in calls:
            per_fwd[c["key"][0]] = per_fwd.get(c["key"][0], 0) + 1
        if per_fwd != PER_FORWARD:
            failures.append(f"calls per Joint forward {per_fwd}")
        totals = check_kernel_calls(torch, calls, log, failures)

        # ---- 3. the main path through the port's CLI
        ops.reset_launch_counts()
        cwd = os.getcwd()
        os.chdir(work)
        try:
            t0 = time.time()
            dsc = target_main.main([
                "smoke", "--method", "domain_adaptation", "--test_only",
                "--load_prefix_joint", "smoke", "--save_root",
                os.path.join(work, "3dmodel"), "--val_list", "NIH_val",
                "--val_data_root", data, "--data_path", manifest,
                "--val_batch", "1", "--device", "cuda"])
            torch.cuda.synchronize()
            cli_s = time.time() - t0
        finally:
            os.chdir(cwd)
        launches = ops.launch_counts()
        want = {k: v * args.cases for k, v in PER_FORWARD.items()}
        score_path = os.path.join(work, "tensorboard", "smoke",
                                  "score_0.json")
        scores = {}
        if os.path.exists(score_path):
            with open(score_path) as f:
                scores = json.load(f)
        if len(scores) != args.cases or \
                not all(0.0 <= v <= 1.0 for v in scores.values()):
            failures.append(f"score JSON {score_path}: {scores}")
        if launches != want:
            failures.append(f"launches {launches} != {want}")

        with torch.no_grad():
            pred_k, recon_k, mean_k, std_k = model(image)
            pred_k2, recon_k2 = model(image)[:2]
            with plain_ops():
                pred_p, recon_p, mean_p, std_p = model(image)
                plain_fwd_ms = forward_ms(torch, model, image, reps=3)
            with plain_ops(reordered=True):
                pred_r, recon_r = model(image)[:2]
            onehot = L.one_hot_label(label, 2)
            dice = [L.avg_dsc(p, onehot, binary=True, botindex=1, topindex=2,
                              return_mean=False).item()
                    for p in (pred_k, pred_p)]
        fwd_ms = forward_ms(torch, model, image)
        emit({"phase": "divergence",
              "calls": divergence(torch, model, image, calls)}, log)
        pred_d = (pred_k.float() - pred_p.float()).abs()
        recon_d = (recon_k.float() - recon_p.float()).abs()
        mean_rel = ((mean_k - mean_p).abs().max()
                    / mean_p.abs().max()).item()
        std_rel = ((std_k - std_p).abs().max()
                   / std_p.abs().max().clamp_min(1e-30)).item()
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (pred_k, recon_k, mean_k, std_k))
        shapes_ok = tuple(pred_k.shape) == (1, 128, 128, 128, 2) and \
            tuple(recon_k.shape) == (1, 128, 128, 128, 2) and \
            tuple(mean_k.shape) == (1, 128)
        # the kernel and plain paths differ only in f32 summation order; a
        # random-weight Joint amplifies the resulting one-ulp bf16 flips
        # layer by layer, so the probabilities are held to a multiple of
        # what another summation order does to the plain path itself
        drift = {"pred": {"kernel_vs_plain": _mean_abs(pred_k, pred_p),
                          "plain_vs_reordered": _mean_abs(pred_p, pred_r),
                          "kernel_vs_kernel": _mean_abs(pred_k, pred_k2)},
                 "recon": {"kernel_vs_plain": _mean_abs(recon_k, recon_p),
                           "plain_vs_reordered": _mean_abs(recon_p, recon_r),
                           "kernel_vs_kernel": _mean_abs(recon_k, recon_k2)}}
        drift_ok = all(d["kernel_vs_plain"]
                       <= DRIFT_MULTIPLE * d["plain_vs_reordered"]
                       for d in drift.values())
        main_ok = (finite and shapes_ok and drift_ok
                   and abs(dice[0] - dice[1]) <= 0.01)
        if not main_ok:
            failures.append("Joint forward with kernels disagrees with the "
                            "plain path")
        emit({"phase": "main_path", "cases": args.cases, "cli_s": cli_s,
              "mean_dice": dsc, "scores": scores, "launches": launches,
              "launches_expected": want, "forward_ms": fwd_ms,
              "plain_forward_ms": plain_fwd_ms,
              "pred_max_abs_err": pred_d.max().item(),
              "pred_mean_abs_err": pred_d.mean().item(),
              "recon_max_abs_err": recon_d.max().item(),
              "recon_mean_abs_err": recon_d.mean().item(),
              "mean_rel_err": mean_rel, "std_rel_err": std_rel,
              "mean_abs_drift": drift, "drift_multiple": DRIFT_MULTIPLE,
              "dice_kernels": dice[0], "dice_plain": dice[1],
              "finite": finite, "shapes_ok": shapes_ok, "ok": main_ok}, log)
        # ---- 4. where the forward's device time goes
        emit(profile_forward(torch, model, image), log)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 5. summary lines
    kernels = []
    for name in ("conv3", "down_k2s2", "up_k2s2"):
        t = totals.get(name, {})
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": t.get("err"), "ms": t.get("kernel_ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": "bytes" if t.get("bytes_ms", 0) >= t.get("ops_ms", 0)
            else "operations",
            "library_ms": t.get("library_ms")})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"records": log, "kernels": kernels, "failures": failures,
                   "seconds": time.time() - t_start}, f, indent=1)
    if failures:
        for msg in failures:
            print("FAILED:", msg, file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
