#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vae_segmentation_tpu_torch) on one NVIDIA
GPU and check it. Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--cases 3] [--out PATH]

Phases, each printed as JSON records:
  1. card: ``nvidia-smi`` name and power limit; the kernels' nvcc build
     (one nvcc per source, all at once).
  2. kernels: one Joint forward of the eval path runs through the plain
     PyTorch versions (f32 math, TF32 off) with hooks recording every
     kernel-backed call (58 + 9 + 9). Each call's kernel then runs on that
     call's recorded inputs against its recorded plain output: y max abs
     err <= 1e-2 * max|y| (softmax probabilities <= 1e-2 abs), stats sum
     err <= 1e-3 * sum|y| and sumsq rel err <= 1e-3 (atomics add in a
     varying order). Each distinct (kernel, shape, options) is timed beside
     the plain version and one cuDNN call (bf16, channels_last_3d; a
     yardstick only, the port never calls it). ``bound_ms`` is the larger
     of the bytes over 3.35 TB/s and the operations over 989 TFLOP/s (bf16;
     67 TFLOP/s for the two f32 elementwise kernels).
  3. eval path: synthetic cases (from --seed) and a seed-initialised
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
  5. train-step kernels: one adaptation train step (batch 2, 128^3, MC
     dropout 0.5, VAE frozen) runs on the plain path while every kernel
     wrapper's call is recorded, forward and backward (conv3 as forward
     and as dx conv with its ``post`` epilogue, conv3_dk, both bridges and
     their backwards, softmax_vjp, dice_sums). Each call's kernel then runs
     on the recorded inputs against the recorded plain outputs: bf16
     outputs within 1e-2 * max|want|, f32 sums (dk, db, ds/dt, Dice sums)
     within ``F32_TOL`` of their tensor's largest element; conv3_dk's dk
     and db, sums that cancel under an InstanceNorm, against their f64 value
     instead: within ``F32_TOL`` of its largest element or no further from
     it than twice the plain version is. Each distinct
     call is timed beside its plain version and one library call
     (``aten.convolution_backward`` with the matching output mask for the
     backward rows, ``aten._softmax_backward_data`` for softmax_vjp; none
     for dice_sums).
  6. train path: step 1 on the kernel path against the plain path (same
     weights, batch and dropout masks): loss terms and every Seg gradient
     tensor within ``DRIFT_MULTIPLE`` times the plain path's own drift
     under reordered f32 sums, for the full dh loss and for the
     pseudo-label loss alone (whose gradient stays inside the Seg and is
     better conditioned with random weights), and for the backward alone
     across the frozen VAE: one student forward on the kernel path, then
     the backward of the reconstruction Dice, whose gradient reaches the
     Seg only through the VAE, run on that one graph by the kernels, by
     their plain versions and by the reordered plain versions (a fixed
     linear map, so the three agree closely); then 3 steps through
     ``make_adapt_step``
     (launch counts per step derived from the model, finite losses, Seg
     moved, VAE and teacher did not, the EMA moves the teacher's Seg only,
     and after a write through ``weight.data`` every module hands its
     kernel the new weight), ``step_ms``, the host's ``enqueue_ms``, peak memory, the
     device's busy share of a step (under the profiler and against the
     unprofiled ``step_ms``); then the port's target CLI trains two outer epochs (the first
     takes no step, as the reference) on synthetic cases with ``--no_aug``.
  7. the reparam kernel at the vae_train shape [4, 128]: against its plain
     version fed the kernel's own eps (latent within 1e-6 of max|latent|,
     KL within 1e-6 relative), its eps against the plain Philox draw of the
     same seed, the latent at scale 0 equal to mean, its draw as a standard
     normal (2^20 draws of one call and 256 seeds of the step's shape),
     deterministic per seed; timed beside the plain version.
  8. vae_train kernels: one source-recipe vae_train step (batch 4 of warped
     ground-truth masks, 128^3, reparam scale 0.35, nothing frozen) runs on
     the plain path while every kernel call is recorded; each call's kernel
     then runs on the recorded inputs under phase 5's rules and each
     distinct call is timed beside its plain version and library call.
  9. the vae_train step-1 gate: loss terms and every VAE gradient, kernel
     path against plain path (same weights, batch and reparam seed), within
     ``DRIFT_MULTIPLE`` times the plain path's own drift under reordered f32
     sums (each loss term: its own largest drift over four plain-path
     orders, the conv sums split by channels, alone and with K1's norm
     statistics also summed in three shuffled orders); likewise the
     backward alone on one kernel-path forward's graph.
 10. 3 vae_train steps through ``make_vae_train_step`` (launch counts
     derived from the model, reparam_kl once a step, finite losses, every
     weight moved), ``step_ms``, ``enqueue_ms``, peak memory, the warp's
     time, and the device time by kernel family of a profiled step.
 11. the chain through the CLIs with the warp on: ``source_main --method
     vae_train`` and ``--method seg_train`` (two outer epochs each, the
     second's first without a step), then the target CLI adapting from
     their two checkpoints: launches per run derived from the models, score
     JSON with every Dice in [0, 1], three checkpoints each.
 12. the norm route (VAESEG_PALLAS=1: every norm+ReLU through the
     InstanceNorm kernels, no stats epilogue, no prologue), through the
     same functions as phases 3-6 and 10: one Joint eval forward recorded
     on the plain path, every call (K1, K2, K3, norm_stats, norm_apply)
     held against its plain version under phase 5's rules (the norm sums
     against their f64 value), launches 58 / 9 / 9 / 56 / 56 per forward;
     phases 3-4 (the eval CLI, the forward's divergence gate,
     ``forward_ms``, a profile); one adaptation step recorded and every
     call held likewise (norm_bwd_sums and norm_bwd_dx among them); phase
     6's pseudo-label gradient gate and 3 steps; phase 10's 3 vae_train
     steps; each beside the default route's numbers.
 13. the merged backward (VAESEG_MERGED_BWD=1): conv3_bwd on the inputs of
     each conv backward recorded in phase 8, each dx conv paired with the
     conv3_dk call of the same conv, held against the pair's plain outputs
     (dx bf16 rule, (ds, dt) F32_TOL, dk and db against their f64 value)
     and timed beside the pair's kernels, its plain version and
     ``aten.convolution_backward`` with mask (T, T, T) (this check runs
     right after phase 8's, while the recording is alive); phase 10's 3
     vae_train steps on the merged route (31 conv3_bwd, 1 conv3_dk, no dx
     conv a step).
 14. the ``kernels`` line (fourteen kernels; those of an opt-in route
     carry its switch in ``path`` and count their launches on its runs),
     then the last line ``{"ok": true, "device": {...}}``.
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
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
PER_FORWARD = {"conv3": 58, "down_k2s2": 9, "up_k2s2": 9}
# the norm route (VAESEG_PALLAS=1): one InstanceNorm+ReLU per conv but the
# two heads of a Joint forward
PER_NORM_FORWARD = {**PER_FORWARD, "norm_stats": 56, "norm_apply": 56}
KERNEL_NAMES = ("conv3", "down_k2s2", "up_k2s2", "conv3_dk", "down_k2s2_bwd",
                "up_k2s2_bwd", "softmax_vjp", "dice_sums", "reparam_kl",
                "conv3_bwd", "norm_stats", "norm_apply", "norm_bwd_sums",
                "norm_bwd_dx")
# the kernels that run only on an opt-in route: their launches are counted
# on that route's runs (phases 12 and 13)
NORM_KERNELS = ("norm_stats", "norm_apply", "norm_bwd_sums", "norm_bwd_dx")
# f32 sums of a backward kernel (dk, db, ds/dt, Dice sums): max abs error
# over the tensor's largest element (atomics add in a varying order;
# measured up to 2e-5 on an H100 over one train step at 128^3, batch 2)
F32_TOL = 2e-4
TRAIN_BATCH, TRAIN_LR, TRAIN_LAMBDA = 2, 1e-3, 1.0
# the source recipes (scripts/source/*.bash): batch 4, SGD at lr 1e-2; the
# VAE's reparam scale 0.35 (make_vae_train_step)
VAE_BATCH, VAE_LR, VAE_SCALE = 4, 1e-2, 0.35
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
    "conv3_dk": ("vae_segmentation_tpu_torch/ops/kernels/csrc/conv3_dk.cu",
                 "vae_segmentation_tpu/ops/pallas/stencil3.py:631 "
                 "(_run_dk_grouped); vae_segmentation_tpu/ops/pallas/"
                 "stencil3.py:777 (_run_dk)"),
    "down_k2s2_bwd": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                      "bridge_bwd.cu",
                      "vae_segmentation_tpu/ops/pallas/upbridge.py:342 "
                      "(_run_down_bwd); vae_segmentation_tpu/ops/pallas/"
                      "upbridge.py:552 (_run_down_bwd_pre)"),
    "up_k2s2_bwd": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                    "bridge_bwd.cu",
                    "vae_segmentation_tpu/ops/pallas/upbridge.py:143 "
                    "(_run_bwd)"),
    "softmax_vjp": ("vae_segmentation_tpu_torch/ops/kernels/csrc/losses.cu",
                    "vae_segmentation_tpu/ops/pallas/softmaxvjp.py:64 "
                    "(softmax_group_vjp)"),
    "dice_sums": ("vae_segmentation_tpu_torch/ops/kernels/csrc/losses.cu",
                  "vae_segmentation_tpu/ops/pallas/dicesums.py:73 (_run)"),
    "reparam_kl": ("vae_segmentation_tpu_torch/ops/kernels/csrc/reparam.cu",
                   "vae_segmentation_tpu/ops/pallas/reparam.py:91 (_run, "
                   "the TPU's on-core draw); vae_segmentation_tpu/ops/pallas/"
                   "reparam.py:101 (_run, off the TPU)"),
    "conv3_bwd": ("vae_segmentation_tpu_torch/ops/kernels/csrc/conv3_bwd.cu",
                  "vae_segmentation_tpu/ops/pallas/stencil3.py:920 "
                  "(_run_bwd_grouped)"),
    "norm_stats": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                   "instance_norm.cu",
                   "vae_segmentation_tpu/ops/pallas/instance_norm.py:125 "
                   "(_per_lane_stats)"),
    "norm_apply": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                   "instance_norm.cu",
                   "vae_segmentation_tpu/ops/pallas/instance_norm.py:147 "
                   "(_apply_per_lane)"),
    "norm_bwd_sums": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                      "instance_norm.cu",
                      "vae_segmentation_tpu/ops/pallas/instance_norm.py:269 "
                      "(_bwd, first pass)"),
    "norm_bwd_dx": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                    "instance_norm.cu",
                    "vae_segmentation_tpu/ops/pallas/instance_norm.py:285 "
                    "(_bwd, second pass)"),
}


@contextmanager
def route(*switches):
    """Within: the given environment switches (VAESEG_PALLAS,
    VAESEG_MERGED_BWD) set to "1"; the models and Functions read them on
    every forward and backward."""
    old = {k: os.environ.get(k) for k in switches}
    os.environ.update({k: "1" for k in switches})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def kernel_ops() -> list:
    """(kernel name, module, wrapper attribute, plain version) of every
    kernel wrapper the port launches."""
    from vae_segmentation_tpu_torch.ops import (
        bridges, conv3, instance_norm, losses, reparam)

    norm = instance_norm
    return [("conv3", conv3, "conv3_op", conv3.conv3_plain),
            ("conv3_dk", conv3, "conv3_dk", conv3.conv3_dk_plain),
            ("down_k2s2", bridges, "down_k2s2_op", bridges.down_k2s2_plain),
            ("up_k2s2", bridges, "up_k2s2_op", bridges.up_k2s2_plain),
            ("down_k2s2_bwd", bridges, "down_k2s2_bwd",
             bridges.down_k2s2_bwd_plain),
            ("up_k2s2_bwd", bridges, "up_k2s2_bwd",
             bridges.up_k2s2_bwd_plain),
            ("softmax_vjp", losses, "softmax_vjp", losses.softmax_vjp_plain),
            ("dice_sums", losses, "dice_sums", losses.dice_sums_plain),
            ("reparam_kl", reparam, "reparam_kl_op",
             reparam.reparam_kl_seeded_plain),
            ("conv3_bwd", conv3, "conv3_bwd", conv3.conv3_bwd_plain),
            ("norm_stats", norm, "norm_stats", norm.norm_stats_plain),
            ("norm_apply", norm, "norm_apply", norm.norm_apply_plain),
            ("norm_bwd_sums", norm, "norm_bwd_sums",
             norm.norm_bwd_sums_plain),
            ("norm_bwd_dx", norm, "norm_bwd_dx", norm.norm_bwd_dx_plain)]


def _plain_args(plain, args: dict) -> dict:
    """The wrapper's bound arguments that its plain version takes (all but
    the kernel-layout weight and the need_* switches)."""
    return {k: v for k, v in args.items()
            if k in inspect.signature(plain).parameters}


def _shuffled_stats(torch, seed: int, parts: int = 64):
    """conv3's plain (sum, sumsq) statistics as `parts` partial sums over
    the flattened volume, added one by one in an order drawn from `seed`:
    the same function with another f32 summation order, of the kind K1's
    atomics give its statistics on every run."""
    gen = torch.Generator().manual_seed(seed)

    def run(y):
        y32 = y.float().reshape(y.shape[0], -1, y.shape[-1])
        sums = [torch.stack([p.sum(dim=1), (p * p).sum(dim=1)], dim=1)
                for p in torch.tensor_split(y32, parts, dim=1)]
        order = torch.randperm(len(sums), generator=gen).tolist()
        acc = sums[order[0]]
        for i in order[1:]:
            acc = acc + sums[i]
        return acc
    return run


@contextmanager
def plain_ops(reordered: bool = False, record: list = None,
              stats_seed: int = None):
    """Within: every kernel wrapper runs its plain PyTorch version instead
    (f32 math on the same bf16 values), forward and backward: the models
    and the autograd Functions stay as they are. reordered=True also splits
    each plain conv's input channels in two halves: the plain path with
    another f32 summation order. With stats_seed, the plain K1's norm
    statistics are also summed in another order (``_shuffled_stats``). With
    `record`, every call is appended as {'kernel', 'args' (the wrapper's
    bound arguments), 'out'}."""
    import torch
    import torch.nn.functional as F

    from vae_segmentation_tpu_torch.ops import bridges, conv3

    def plain_wrapper(name, real, plain):
        sig = inspect.signature(real)

        def run(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            out = plain(**_plain_args(plain, bound.arguments))
            if record is not None:
                record.append({"kernel": name, "args": dict(bound.arguments),
                               "out": out})
            return out
        return run

    with ExitStack() as stack:
        for name, mod, attr, plain in kernel_ops():
            stack.enter_context(mock.patch.object(
                mod, attr, plain_wrapper(name, getattr(mod, attr), plain)))
        if reordered:
            ns = types.SimpleNamespace(
                conv3d=_split_sums(F.conv3d, F),
                conv_transpose3d=_split_sums(F.conv_transpose3d, F))
            for mod in (conv3, bridges):
                stack.enter_context(mock.patch.object(mod, "F", ns))
        if stats_seed is not None:
            stack.enter_context(mock.patch.object(
                conv3, "_stats", _shuffled_stats(torch, stats_seed)))
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

    w, b, kw = m.weight, m.bias, m.kernel_weight()
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


FAMILIES = tuple((rf"\b{k}\b", f) for k, f in (
    ("conv3_dk_kernel", "conv3_dk"), ("conv3_bwd_kernel", "conv3_bwd"),
    ("conv3_kernel", "conv3"), ("down_dx_kernel", "down_k2s2_bwd"),
    ("up_dx_kernel", "up_k2s2_bwd"), ("bridge_dk_kernel", "bridge_dk"),
    ("down_kernel", "down_k2s2"), ("up_kernel", "up_k2s2"),
    ("softmax_vjp_c2_kernel", "softmax_vjp"),
    ("softmax_vjp_kernel", "softmax_vjp"), ("dice_sums_kernel", "dice_sums"),
    ("reparam_kl_kernel", "reparam_kl"))) + (
    # one template each serves two kernels of the table, by its mode
    (r"\bnorm_reduce_kernel<0>", "norm_stats"),
    (r"\bnorm_reduce_kernel<1>", "norm_bwd_sums"),
    (r"\bnorm_elementwise_kernel<0>", "norm_apply"),
    (r"\bnorm_elementwise_kernel<1>", "norm_bwd_dx"))


def _family(name: str) -> str:
    """The kernel family of a profiler event (``bridge_dk`` is the dk/db
    kernel that both bridge backwards share)."""
    for pattern, family in FAMILIES:
        if re.search(pattern, name):
            return family
    # cuBLAS on Hopper names its GEMMs nvjet_*
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "cutlass")):
        return "gemm"
    return "other"


def profile_run(torch, fn, reps: int, phase: str) -> dict:
    """Device ms per call of fn() by kernel family (kernel events of
    ``torch.profiler``), host-clock wall ms per call, and their ratio, the
    device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
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
    return {"phase": phase, "reps": reps, "wall_ms": wall_ms,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "device_ms_by_family": by_family,
            "largest_other": sorted(other, reverse=True)[:5]}


def graph_ms(torch, fn, n: int = 20, replays: int = 3) -> float:
    """Device time of one fn() call with no host work in the window: n
    calls captured in a CUDA graph, the graph replayed between CUDA
    events. The warm-up call runs on a side stream, as a captured
    autograd backward needs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def profile_forward(torch, model, image, reps: int = 5,
                    phase: str = "profile") -> dict:
    """Phase 4: where the eval forward's device time goes."""
    def forward():
        with torch.no_grad():
            model(image)
    return profile_run(torch, forward, reps, phase)


def profile_step(torch, fn, step_ms: float, phase: str, log: list) -> None:
    """Where a train step's device time goes (profile_run over 2 calls of
    fn), emitted; the profiler slows the host, so also the device time over
    the unprofiled step_ms."""
    prof = profile_run(torch, fn, 2, phase)
    prof["busy_share_of_step_ms"] = prof["device_ms"] / step_ms
    emit(prof, log)


def timed_steps(torch, ops, step, n: int = 3, after_first=None) -> dict:
    """n calls of step(i), each synchronised: host-clock ``step_ms`` and
    ``enqueue_ms`` (a step returns without waiting for the card: the host's
    share of a step is the time to enqueue it), each with the median, the
    launches and loss values of each step, whether all losses are finite,
    and the peak memory. after_first() runs after the first step."""
    torch.cuda.reset_peak_memory_stats()
    step_ms, enqueue_ms, launches, losses = [], [], [], []
    for i in range(n):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = step(i)
        enqueue_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(ops.launch_counts())
        losses.append({k: v.item() for k, v in aux.items()})
        if i == 0 and after_first is not None:
            after_first()
    return {"step_ms": sorted(step_ms)[n // 2], "step_ms_all": step_ms,
            "enqueue_ms": sorted(enqueue_ms)[n // 2], "launches": launches,
            "losses": losses,
            "finite": all(v == v and abs(v) != float("inf")
                          for rec in losses for v in rec.values()),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


# ---- the train step: every kernel call, forward and backward


def describe(rec: dict) -> dict:
    """What distinguishes one recorded kernel call: kernel, role, input
    shape, output channels and options."""
    a, k = rec["args"], rec["kernel"]
    if k == "reparam_kl":
        return {"kernel": k, "shape": list(a["mean"].shape)}
    if k == "softmax_vjp":
        return {"kernel": k, "shape": list(a["y"].shape)}
    if k == "dice_sums":
        return {"kernel": k, "shape": list(a["pred"].shape),
                "targets": len(a["targets"])}
    if k in NORM_KERNELS:
        d = {"kernel": k, "shape": list(a["x"].shape)}
        if "relu" in a:
            d["relu"] = bool(a["relu"])
        return d
    d = {"kernel": k, "shape": list(a["x"].shape),
         "pre": a.get("pre") is not None}
    if k in ("conv3_dk", "conv3_bwd"):
        d["cout"] = a["gy"].shape[-1]
        return d
    d["cout"] = a["kweight"].shape[-1]
    if k == "conv3":
        d.update(role="fwd" if a["bias"] is not None else "dx",
                 stats=bool(a["stats"]), softmax=bool(a["softmax"]),
                 post=a["post"] is not None)
    if k.endswith("_bwd"):
        d.update(need_dx=bool(a["need_dx"]), need_dk=bool(a["need_dk"]))
    return d


def op_work(d: dict) -> tuple:
    """(bytes, flops, peak flop/s) of one described call: every input read
    once, every output written once; bf16 volumes and weights, f32 bias,
    affines and sums. The convs count against the bf16 tensor-core peak,
    the two elementwise kernels against the f32 peak."""
    k, shape = d["kernel"], d["shape"]
    if k == "reparam_kl":
        return reparam_work(shape[0] * shape[1])
    b, c = shape[0], shape[-1]
    n = 1
    for e in shape[:-1]:
        n *= e                      # voxels of the input, batch included
    if k == "softmax_vjp":
        return 3 * 2 * n * c, 4 * n * c, F32_FLOPS_PER_S
    if k == "dice_sums":
        t = d["targets"]
        return (2 * n * c * (1 + t) + 4 * b * (1 + 2 * t) * c,
                n * c * (1 + 3 * t), F32_FLOPS_PER_S)
    if k in NORM_KERNELS:
        # bf16 volumes read (x; g in the backward) and written (y, dx); f32
        # (s, t), (m1, m2) and [B, 2, C] sums; per element: sum and square
        # (2), affine and ReLU (3), affine, mask and two products (5),
        # affine, mask and the dx expression (7)
        vols, small, ops = {"norm_stats": (1, 1, 2), "norm_apply": (2, 1, 3),
                            "norm_bwd_sums": (2, 2, 5),
                            "norm_bwd_dx": (3, 2, 7)}[k]
        return 2 * n * c * vols + 8 * b * c * small, ops * n * c, \
            F32_FLOPS_PER_S
    cout, pre = d["cout"], d["pre"]
    aff = 8 * b * c if pre else 0
    if k == "conv3_bwd":
        # reads x, gy, the weight (and s, t); writes dx, dk, db (and ds,
        # dt); the dx conv's and the dk pass's 27 Cin Cout MACs a voxel
        return (2 * n * c + 2 * n * cout + 2 * 27 * c * cout + 2 * n * c
                + 4 * 27 * c * cout + 4 * cout + 2 * aff,
                2 * 2 * n * 27 * c * cout, BF16_FLOPS_PER_S)
    if k in ("conv3", "down_k2s2", "up_k2s2"):
        nbytes, flops = work_of(k, shape, c, cout, pre, d.get("stats", False))
        if d.get("post"):           # reads the forward's x, s, t; writes dst
            nbytes += 2 * n * cout + 16 * b * cout
        return nbytes, flops, BF16_FLOPS_PER_S
    if k == "conv3_dk":
        return (2 * n * c + 2 * n * cout + 4 * 27 * c * cout + 4 * cout + aff,
                2 * n * 27 * c * cout, BF16_FLOPS_PER_S)
    dx, dk = d["need_dx"], d["need_dk"]
    # x is the fine grid for down (n voxels, n / 8 of gy), the coarse grid
    # for up (n voxels, 8 n of gy); 8 Cin Cout MACs per coarse voxel each
    # for dx and for dk
    coarse, n_gy = (n // 8, n // 8) if k == "down_k2s2_bwd" else (n, 8 * n)
    reads_x = dk or pre
    nbytes = (2 * n_gy * cout + 2 * 8 * c * cout + aff
              + (2 * n * c if reads_x else 0)
              + ((2 * n * c + (8 * b * c if pre else 0)) if dx else 0)
              + ((4 * 8 * c * cout + 4 * cout) if dk else 0))
    return nbytes, 2 * coarse * 8 * c * cout * (int(dx) + int(dk)), \
        BF16_FLOPS_PER_S


def _outputs(out) -> list:
    """The tensors of a wrapper's result, in order (None kept)."""
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare_call(torch, d: dict, got, want) -> dict:
    """Errors of one kernel call against the recorded plain result: bf16
    outputs within 1e-2 of the largest |want| (softmax probabilities 1e-2
    abs), f32 sums within F32_TOL of their tensor's largest element; a
    forward conv with stats keeps phase 2's rule. Outputs the kernel was
    told to skip (None) are not compared."""
    if d["kernel"] == "conv3" and d.get("stats"):
        return _compare(torch, "conv3", False, got, want)
    rec = {"max_abs_err": 0.0, "bf16_rel_err": 0.0, "f32_rel_err": 0.0,
           "rel_err_by_output": [], "ok": True}
    for g, w in zip(_outputs(got), _outputs(want)):
        if g is None:
            rec["rel_err_by_output"].append(None)
            continue
        err = (g.float() - w.float()).abs().max().item()
        scale = max(w.float().abs().max().item(), 1e-30)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["rel_err_by_output"].append(err / scale)
        if g.dtype == torch.float32:
            rec["f32_rel_err"] = max(rec["f32_rel_err"], err / scale)
            ok = err <= F32_TOL * scale
        else:
            rec["bf16_rel_err"] = max(rec["bf16_rel_err"], err / scale)
            ok = err <= (1e-2 if d.get("softmax") else 1e-2 * scale)
        rec["ok"] = rec["ok"] and ok and bool(torch.isfinite(g).all())
    return rec


def conv3_dk_exact(torch, a: dict) -> tuple:
    """dk, db of a recorded conv3_dk call in f64: the prologue rounded in
    f32 as the kernel rounds it, each product of an f32 value and a bf16
    cotangent exact in f64, the sums f64 (to 1e-16 of their terms)."""
    from vae_segmentation_tpu_torch.ops import conv3

    x, gy, pre = a["x"], a["gy"], a.get("pre")
    xin = (x.float() if pre is None else conv3._affine_relu(x, pre)).double()
    cin, cout = x.shape[-1], gy.shape[-1]
    g = gy.double().permute(0, 4, 1, 2, 3)
    dw = torch.nn.grad.conv3d_weight(xin.permute(0, 4, 1, 2, 3),
                                     (cout, cin, 3, 3, 3), g, padding=1)
    return (dw.permute(2, 3, 4, 1, 0).reshape(27, cin, cout),
            g.sum(dim=(0, 2, 3, 4)))


def norm_sums_exact(torch, kernel: str, a: dict):
    """The [B, 2, C] sums of a recorded norm_stats or norm_bwd_sums call in
    f64: x (and g) as given, xhat = x * s + t rounded in f32 as the kernel
    rounds it, each product of two f32 values exact in f64."""
    from vae_segmentation_tpu_torch.ops import instance_norm

    if kernel == "norm_stats":
        v = a["x"].double()
        w = v * v
    else:
        gm, xhat = instance_norm._masked(a["x"], a["g"], a["s"], a["t"],
                                         a["relu"])
        v = gm.double()
        w = v * xhat.double()
    return torch.stack([v.sum(dim=(1, 2, 3)), w.sum(dim=(1, 2, 3))], dim=1)


# the kernels whose f32 sums are held to their f64 value (exact_compare)
EXACT = ("conv3_dk", "conv3_bwd", "norm_stats", "norm_bwd_sums")


def exact_parts(torch, kernel: str, a: dict, got, want) -> list:
    """(kernel's, plain version's, f64) triples of the sums of one call
    that exact_compare holds: conv3_dk's dk and db, conv3_bwd's dk and db,
    and each row of a norm kernel's [B, 2, C] sums."""
    if kernel in ("conv3_dk", "conv3_bwd"):
        first = 1 if kernel == "conv3_bwd" else 0
        return list(zip(got[first:first + 2], want[first:first + 2],
                        conv3_dk_exact(torch, a)))
    ref = norm_sums_exact(torch, kernel, a)
    return [(got[:, r], want[:, r], ref[:, r]) for r in range(2)]


def exact_compare(torch, kernel: str, a: dict, got, want,
                  rec: dict) -> dict:
    """A call's sums against their f64 value (``exact_parts``). The weight
    gradient of a conv under an InstanceNorm cancels far below its terms
    (db is zero in exact arithmetic), and so do the norm backward's sums, so
    two f32 orders of the same sum, the kernel's and the plain version's,
    can differ by more than F32_TOL of the result while both are right to
    f32 rounding. Each is held to F32_TOL of its exact largest element, or
    to twice the plain version's own distance from the exact value where
    that is larger: no less accurate than the library's f32 sum.
    conv3_bwd's dx (bf16 rule) and (ds, dt) (F32_TOL) keep compare_call's
    rules."""
    rec = dict(rec, exact_rel_err=[], plain_exact_rel_err=[])
    ok = True
    if kernel == "conv3_bwd":
        errs = rec["rel_err_by_output"]
        ok = errs[0] <= 1e-2 and (errs[3] is None or errs[3] <= F32_TOL) \
            and bool(torch.isfinite(got[0].float()).all())
    for g, w, ref in exact_parts(torch, kernel, a, got, want):
        scale = max(ref.abs().max().item(), 1e-300)
        ek = (g.double() - ref).abs().max().item() / scale
        ep = (w.double() - ref).abs().max().item() / scale
        rec["exact_rel_err"].append(ek)
        rec["plain_exact_rel_err"].append(ep)
        ok = ok and ek <= max(F32_TOL, 2.0 * ep) \
            and bool(torch.isfinite(g).all())
    rec["ok"] = ok
    return rec


def _worst_rel(rec: dict) -> float:
    """The largest relative error of a compared call."""
    return max(rec.get("bf16_rel_err", 0.0), rec.get("f32_rel_err", 0.0),
               rec.get("stats_sum_err", 0.0), rec.get("stats_sumsq_rel", 0.0),
               rec["max_abs_err"] if "bf16_rel_err" not in rec else 0.0)


def _library_fn(torch, d: dict, a: dict):
    """One library call that computes what the described call computes
    (bf16, channels_last_3d), or None: F.conv3d / conv_transpose3d for the
    forwards, aten.convolution_backward with the matching output mask for
    the backwards, aten._softmax_backward_data for softmax_vjp. No single
    call computes the 1 + 2K fused sums of dice_sums, nor draws and reduces
    as reparam_kl does."""
    import torch.nn.functional as F

    k = d["kernel"]
    if k == "softmax_vjp":
        return lambda: torch.ops.aten._softmax_backward_data(
            a["g"], a["y"], -1, torch.bfloat16)
    if k in ("dice_sums", "reparam_kl", "norm_bwd_sums"):
        return None

    def cl(t):                      # NDHWC data seen as channels_last_3d
        return t.permute(0, 4, 1, 2, 3)

    if k == "norm_stats":           # row 15 alone: mean and variance
        return lambda: torch.var_mean(a["x"], dim=(1, 2, 3))
    if k == "norm_apply":           # rows 15 and 16 as one call
        return lambda: F.instance_norm(cl(a["x"]))
    if k == "norm_bwd_dx":          # both passes of row 17 as one backward
        # with its forward: autograd runs a backward on its forward's
        # stream, so the two are captured together (check_step_calls takes
        # the forward's time off)
        xl = cl(a["x"]).detach().requires_grad_(True)

        def forward_backward():
            with torch.enable_grad():
                return torch.autograd.grad(F.instance_norm(xl), xl,
                                           cl(a["g"]))
        return forward_backward

    def wl(w):
        return w.detach().to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)

    def bwd(gy, x, w, cout, stride, pad, transposed, mask):
        return lambda: torch.ops.aten.convolution_backward(
            cl(gy), cl(x), w, [cout], [stride] * 3, [pad] * 3, [1] * 3,
            transposed, [0] * 3, 1, mask)

    x = a["x"]
    if k == "conv3" and d["role"] == "fwd":
        w, bias = wl(a["weight"]), a["bias"].to(torch.bfloat16)
        return lambda: F.conv3d(cl(x), w, bias, padding=1)
    if k == "conv3":
        # the dx conv: x is the cotangent gy, weight the flipped transpose
        w = wl(a["weight"].flip(2, 3, 4).transpose(0, 1))
        fwd_x = a["post"][0] if a["post"] is not None else \
            torch.empty(*x.shape[:-1], d["cout"], dtype=x.dtype,
                        device=x.device)
        return bwd(x, fwd_x, w, x.shape[-1], 1, 1, False,
                   [True, False, False])
    if k == "conv3_dk":
        w = wl(torch.empty(d["cout"], x.shape[-1], 3, 3, 3, device=x.device))
        return bwd(a["gy"], x, w, d["cout"], 1, 1, False,
                   [False, True, True])
    if k == "conv3_bwd":
        return bwd(a["gy"], x, wl(a["weight"]), d["cout"], 1, 1, False,
                   [True, True, True])
    w = wl(a["weight"])
    if k == "down_k2s2":
        bias = a["bias"].to(torch.bfloat16)
        return lambda: F.conv3d(cl(x), w, bias, stride=2)
    if k == "up_k2s2":
        bias = a["bias"].to(torch.bfloat16)
        return lambda: F.conv_transpose3d(cl(x), w, bias, stride=2)
    mask = [d["need_dx"], d["need_dk"], d["need_dk"]]
    return bwd(a["gy"], x, w, d["cout"], 2, 0, k == "up_k2s2_bwd", mask)


def pair_fn(a: dict):
    """The default backward a merged conv3_bwd call replaces, on its
    inputs: K1 as the dx conv (with the post epilogue under the prologue),
    then conv3_dk."""
    from vae_segmentation_tpu_torch.ops import conv3

    w, kw, pre = a["weight"], a["kweight"], a["pre"]
    w_t = w.flip(2, 3, 4).transpose(0, 1)
    kw_t = kw.flip(0).transpose(1, 2).contiguous()
    post = None if pre is None else (a["x"], *pre)

    def run():
        conv3.conv3_op(a["gy"], w_t, None, kw_t, post=post)
        conv3.conv3_dk(a["x"], a["gy"], pre)
    return run


def merged_calls(calls) -> list:
    """conv3_bwd calls built from a recorded default backward: each dx conv
    (K1 without bias) paired with the conv3_dk call that follows it on the
    same cotangent, with the pair's plain outputs as (dx, dk, db, dst)."""
    out = []
    for dx_call, dk_call in zip(calls, calls[1:]):
        ad, ak = dx_call["args"], dk_call["args"]
        if dx_call["kernel"] != "conv3" or ad["bias"] is not None \
                or dk_call["kernel"] != "conv3_dk" or ak["gy"] is not ad["x"]:
            continue
        post = ad["post"] is not None
        dx, dst = dx_call["out"] if post else (dx_call["out"], None)
        kw = ad["kweight"].flip(0).transpose(1, 2).contiguous()
        out.append({"kernel": "conv3_bwd",
                    "args": {"x": ak["x"], "gy": ak["gy"],
                             "weight": ad["weight"].transpose(0, 1)
                             .flip(2, 3, 4), "kweight": kw,
                             "pre": ak["pre"]},
                    "out": (dx, *dk_call["out"], dst)})
    return out


def check_step_calls(torch, calls, log, failures,
                     phase: str = "step_kernel") -> dict:
    """Phases 5 and 8: every kernel call of a recorded train step, kernel on
    the plain path's inputs against the plain path's outputs; each distinct
    call also timed (kernel, plain, library) and bounded. Returns per-kernel
    totals over the step."""
    real = {name: (getattr(mod, attr), plain)
            for name, mod, attr, plain in kernel_ops()}
    keys = {}
    with torch.no_grad():
        for c in calls:
            d = describe(c)
            got = real[d["kernel"]][0](**c["args"])
            rec = compare_call(torch, d, got, c["out"])
            if d["kernel"] in EXACT:
                rec = exact_compare(torch, d["kernel"], c["args"], got,
                                    c["out"], rec)
            del got
            k = keys.setdefault(json.dumps(d, sort_keys=True),
                                {"count": 0, "first": c, "desc": d,
                                 "ok": True, "worst": rec})
            k["count"] += 1
            k["ok"] = k["ok"] and rec["ok"]
            if _worst_rel(rec) >= _worst_rel(k["worst"]):
                k["worst"] = rec
    torch.cuda.synchronize()

    totals = {}
    for k in keys.values():
        d, a = k["desc"], k["first"]["args"]
        wrapper, plain = real[d["kernel"]]
        pargs = _plain_args(plain, a)
        library = _library_fn(torch, d, a)
        rec = {"phase": phase, **d, "calls_per_step": k["count"],
               **k["worst"], "ok": k["ok"]}
        with torch.no_grad():
            if d["kernel"] in NORM_KERNELS:
                # a norm kernel at 4^3-64^3 runs for less time than its
                # wrapper takes to enqueue it, so CUDA events around
                # repeated calls time the host (kept beside): these calls,
                # their plain versions and their library calls are timed as
                # a replayed CUDA graph
                rec["kernel_events_ms"] = cuda_ms(torch, lambda: wrapper(**a))
                rec["kernel_ms"] = graph_ms(torch, lambda: wrapper(**a))
                rec["plain_ms"] = graph_ms(torch, lambda: plain(**pargs))
                rec["library_ms"] = None if library is None \
                    else graph_ms(torch, library)
                if d["kernel"] == "norm_bwd_dx":
                    rec["library_forward_backward_ms"] = rec["library_ms"]
                    rec["library_forward_ms"] = graph_ms(
                        torch, lambda: torch.nn.functional.instance_norm(
                            a["x"].permute(0, 4, 1, 2, 3)))
                    rec["library_ms"] -= rec["library_forward_ms"]
                rec["timed_by"] = "cuda graph replay"
            else:
                rec["kernel_ms"] = cuda_ms(torch, lambda: wrapper(**a))
                rec["plain_ms"] = cuda_ms(torch, lambda: plain(**pargs),
                                          budget_ms=20.0, max_reps=10)
                rec["library_ms"] = None if library is None \
                    else cuda_ms(torch, library)
                rec["timed_by"] = "cuda events"
            if d["kernel"] == "conv3_bwd":
                rec["pair_ms"] = cuda_ms(torch, pair_fn(a))
        nbytes, flops, peak = op_work(d)
        rec["bytes"], rec["flops"] = nbytes, flops
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak
        rec["bound_ms"] = max(bytes_ms, ops_ms)
        rec["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        emit(rec, log)
        if not rec["ok"]:
            failures.append(f"{phase}: {d} disagrees with its plain version")
        name = d["kernel"] + ("" if d.get("role", "fwd") == "fwd" else "/dx")
        t = totals.setdefault(name, dict(
            err=0.0, bf16_rel_err=0.0, f32_rel_err=0.0, kernel_ms=0.0,
            plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
            ops_ms=0.0, calls=0))
        if "pair_ms" in rec:
            t["pair_ms"] = t.get("pair_ms", 0.0) + k["count"] * rec["pair_ms"]
        n = k["count"]
        t["err"] = max(t["err"], rec["max_abs_err"])
        for f in ("bf16_rel_err", "f32_rel_err"):
            t[f] = max(t[f], rec.get(f, 0.0))
        t["calls"] += n
        for f in ("kernel_ms", "plain_ms", "bound_ms"):
            t[f] += n * rec[f]
        t["library_ms"] = None if library is None \
            else t["library_ms"] + n * rec["library_ms"]
        t["bytes_ms"] += n * bytes_ms
        t["ops_ms"] += n * ops_ms
    return totals


# ---- the train path


def expected_step_launches(joint) -> dict:
    """Kernel launches of one adaptation step (no KL term, one MC pass),
    derived from the model: the teacher's Seg forward, the student's Joint
    forward, a dx conv for every conv but the Seg's entry conv (the image
    needs no gradient), a weight gradient for the Seg's convs only (the VAE
    is frozen; its bridges' backwards skip dk and db), the softmax VJP of
    both heads and one fused Dice-sums pass."""
    from vae_segmentation_tpu_torch.models.blocks import (
        Conv3, DownConv, TConv2)

    def count(net, cls):
        return sum(isinstance(m, cls) for m in net.modules())

    conv = [count(net, Conv3) for net in (joint.Seg, joint.Vae)]
    down = [count(net, DownConv) for net in (joint.Seg, joint.Vae)]
    up = [count(net, TConv2) for net in (joint.Seg, joint.Vae)]
    return {**{k: 0 for k in KERNEL_NAMES},
            "conv3": conv[0] + sum(conv) + sum(conv) - 1,
            "down_k2s2": down[0] + sum(down), "up_k2s2": up[0] + sum(up),
            "conv3_dk": conv[0], "down_k2s2_bwd": sum(down),
            "up_k2s2_bwd": sum(up), "softmax_vjp": 2, "dice_sums": 1,
            "reparam_kl": 0}


def expected_norm_step_launches(joint) -> dict:
    """``expected_step_launches`` on the norm route: the same convs and
    bridges, plus one norm_stats and norm_apply per norm of the teacher's
    Seg forward and the student's Joint forward (a norm after every conv
    but a head), and one norm_bwd_sums and norm_bwd_dx per norm of the
    student (the frozen VAE's too: the gradient crosses it to the Seg)."""
    from vae_segmentation_tpu_torch.models.blocks import Conv3

    norms = [_count(net, Conv3) - 1 for net in (joint.Seg, joint.Vae)]
    fwd, bwd = norms[0] + sum(norms), sum(norms)
    return {**expected_step_launches(joint), "norm_stats": fwd,
            "norm_apply": fwd, "norm_bwd_sums": bwd, "norm_bwd_dx": bwd}


def count_calls(calls) -> dict:
    """Recorded kernel calls per kernel name."""
    out = {k: 0 for k in KERNEL_NAMES}
    for c in calls:
        out[c["kernel"]] += 1
    return out


def expected_backward_launches(joint) -> dict:
    """Kernel launches of the backward alone of one student forward: what
    ``expected_step_launches`` counts less the forwards and the Dice sums."""
    step, fwd = expected_step_launches(joint), PER_FORWARD
    seg_conv = step["conv3_dk"]
    return {**{k: 0 for k in KERNEL_NAMES},
            "conv3": step["conv3"] - seg_conv - fwd["conv3"],
            "conv3_dk": seg_conv, "down_k2s2_bwd": step["down_k2s2_bwd"],
            "up_k2s2_bwd": step["up_k2s2_bwd"], "softmax_vjp": 2}


def stale_kernel_weights(torch, *models) -> list:
    """Names of the kernel-backed modules whose next launch would read
    other values than ``weight`` holds: each module has launched before,
    then its weight is negated through ``weight.data``, a write that no
    version counter sees, and the layout it hands its kernel must be
    ``kernel_layout`` of the new weight. The weight is negated back."""
    stale = []
    for i, model in enumerate(models):
        for name, m in model.named_modules():
            if not hasattr(m, "kernel_weight"):
                continue
            old = m.kernel_weight().clone()
            m.weight.data.neg_()
            new = m.kernel_weight()
            if not torch.equal(new, m.kernel_layout(m.weight)) \
                    or torch.equal(new, old):
                stale.append(f"{i}:{name}")
            m.weight.data.neg_()
    return stale


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def norm_cancelled(key: str) -> bool:
    """A conv bias under an InstanceNorm: its gradient is zero in exact
    arithmetic, so what any path computes there is round-off (the heads and
    the VAE's dense layers have no norm after them)."""
    return key.endswith(".bias") and "out_block" not in key \
        and not key.split(".")[-2].startswith("fc")


def grad_drift(got: dict, want: dict) -> dict:
    """Relative L2 error per gradient tensor, norm-cancelled biases left
    out."""
    return {k: _rel_l2(got[k].float(), w.float()) for k, w in want.items()
            if not norm_cancelled(k)}


def drift_ratios(kernel: dict, plain: dict, reordered: dict) -> tuple:
    """(kernel vs plain, plain vs reordered, their ratio) per gradient
    tensor (grad_drift). A tensor's drift can be small by chance: each is
    held to its own drift or the median tensor's, whichever is larger."""
    err, drift = grad_drift(kernel, plain), grad_drift(reordered, plain)
    median = sorted(drift.values())[len(drift) // 2]
    return err, drift, {k: err[k] / max(drift[k], median) for k in err}


def _mean_abs(a, b) -> float:
    return (a.float() - b.float()).abs().mean().item()


# ---- the source trainers: the reparam kernel, the vae_train step, the chain


# operations of one reparam_kl element: Philox4x32-10 is 10 rounds of two
# 32x32 -> 64-bit products, four xors and two key additions, counted as 100
# integer operations at the f32 rate (the table gives no int32 rate); the
# Box-Muller draw, the latent and the KL term about 24 f32 operations
# (log, sqrt and cos counted as one each)
REPARAM_OPS_PER_ELEMENT = 124


def reparam_work(n: int) -> tuple:
    """(bytes, operations, peak) of reparam_kl over n = B * D elements:
    mean and std read, latent and eps written (f32), the seed and the KL."""
    return 16 * n + 8, REPARAM_OPS_PER_ELEMENT * n, F32_FLOPS_PER_S


def normal_law(x) -> dict:
    """Mean, variance and two-sided tail shares of draws x (f64), each with
    its distance from the standard normal's in standard errors."""
    n = x.numel()
    rec = {"n": n, "mean": x.mean().item(), "var": x.var().item()}
    rec["mean_se"] = abs(rec["mean"]) * n ** 0.5
    rec["var_se"] = abs(rec["var"] - 1.0) / (2.0 / n) ** 0.5
    worst = max(rec["mean_se"], rec["var_se"])
    for t, p in ((1.0, 0.31731), (2.0, 0.04550), (3.0, 0.0026998)):
        share = (x.abs() > t).double().mean().item()
        rec[f"tail_{int(t)}"] = share
        worst = max(worst, abs(share - p) / (p * (1 - p) / n) ** 0.5)
    rec["worst_se"] = worst
    return rec


def check_reparam(torch, seed: int, log, failures) -> dict:
    """Phase 7: the reparam kernel at the vae_train shape [VAE_BATCH, 128]
    against its plain version fed the kernel's own eps (latent within 1e-6
    of max|latent|, KL within 1e-6 relative), its eps against the plain
    Philox draw of the same seed (1e-5), the latent at scale 0 equal to
    mean, its draw as a standard normal (one call of 2^20 and 256 seeds of
    the step's shape, every statistic within 5 standard errors),
    deterministic per seed and different across seeds; timed beside its
    plain version (the draw included) by device time under the profiler:
    CUDA events around repeated calls time the wrapper's host work, which
    takes longer than the one-block kernel (both kept). Returns its totals
    per step."""
    from vae_segmentation_tpu_torch.ops import reparam

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (VAE_BATCH, 128)
    mean = torch.randn(shape, generator=gen, device="cuda") * 0.7
    std = torch.randn(shape, generator=gen, device="cuda").relu()
    seed_t = reparam.draw_seed(gen, "cuda")
    latent, kl, eps = reparam.reparam_kl_op(mean, std, VAE_SCALE, seed_t)
    want_latent, want_kl = reparam.reparam_kl_plain(mean, std, VAE_SCALE,
                                                    eps)
    err = (latent - want_latent).abs().max().item()
    latent_rel = err / want_latent.abs().max().item()
    kl_rel = abs(kl.item() - want_kl.item()) / abs(want_kl.item())
    seed_cpu = seed_t.cpu()
    eps_err = (eps - reparam.philox_normal_plain(
        int(seed_cpu), shape, device="cuda")).abs().max().item()
    zero_ok = torch.equal(
        reparam.reparam_kl_op(mean, std, 0.0, seed_t)[0], mean)

    def draw(s, rows=VAE_BATCH, cols=128):
        z = torch.zeros(rows, cols, device="cuda")
        return reparam.reparam_kl_op(
            z, torch.ones_like(z), 1.0,
            torch.tensor([s], dtype=torch.int32, device="cuda"))[2]

    law_one = normal_law(draw(seed + 1, 1024, 1024).double())
    law_seeds = normal_law(torch.cat([draw(s).reshape(-1)
                                      for s in range(256)]).double())
    same = torch.equal(draw(5), draw(5)) and not torch.equal(draw(5),
                                                             draw(6))
    ok = (latent_rel <= 1e-6 and kl_rel <= 1e-6 and eps_err <= 1e-5
          and zero_ok and same and law_one["worst_se"] <= 5.0
          and law_seeds["worst_se"] <= 5.0
          and bool(torch.isfinite(latent).all()))
    def kernel():
        return reparam.reparam_kl_op(mean, std, VAE_SCALE, seed_t)

    def plain():
        return reparam.reparam_kl_seeded_plain(mean, std, VAE_SCALE,
                                               seed_cpu)

    with torch.no_grad():
        kernel_ms = profile_run(torch, kernel, 50, "")["device_ms"]
        plain_ms = profile_run(torch, plain, 10, "")["device_ms"]
        events_ms = [cuda_ms(torch, fn) for fn in (kernel, plain)]
    nbytes, ops, peak = reparam_work(shape[0] * shape[1])
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / peak
    rec = {"phase": "reparam", "shape": list(shape), "scale": VAE_SCALE,
           "max_abs_err": err, "latent_rel_err": latent_rel,
           "kl_rel_err": kl_rel, "kl": kl.item(),
           "eps_vs_plain_philox": eps_err,
           "scale0_latent_is_mean": zero_ok, "deterministic": same,
           "law_one_call": law_one, "law_256_seeds": law_seeds,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
           "kernel_events_ms": events_ms[0], "plain_events_ms": events_ms[1],
           "bytes": nbytes, "operations": ops,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "ok": ok}
    emit(rec, log)
    if not ok:
        failures.append("reparam_kl disagrees with its plain version or "
                        "its draw is not a standard normal")
    return {"err": err, "f32_rel_err": latent_rel, "bf16_rel_err": 0.0,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": rec["bound_ms"], "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "calls": 1}


def _count(net, cls) -> int:
    return sum(isinstance(m, cls) for m in net.modules())


def forward_launches(net) -> dict:
    """Kernel launches of one forward of a bare SegUNet or ShapeVAE."""
    from vae_segmentation_tpu_torch.models.blocks import (
        Conv3, DownConv, TConv2)

    return {**{k: 0 for k in KERNEL_NAMES}, "conv3": _count(net, Conv3),
            "down_k2s2": _count(net, DownConv), "up_k2s2": _count(net, TConv2)}


def expected_source_step_launches(net, sampled: bool) -> dict:
    """Kernel launches of one vae_train (sampled latent) or seg_train step,
    derived from the model: its forward, a dx conv for every conv but the
    entry conv (the one-hot mask or the image needs no gradient), a weight
    gradient for every conv and bridge (nothing is frozen), the head's
    softmax VJP and, for the VAE, one reparam_kl. The Dice loss is plain
    avg_dsc: no dice_sums."""
    fwd = forward_launches(net)
    return {**fwd, "conv3": 2 * fwd["conv3"] - 1,
            "conv3_dk": fwd["conv3"], "down_k2s2_bwd": fwd["down_k2s2"],
            "up_k2s2_bwd": fwd["up_k2s2"], "softmax_vjp": 1,
            "reparam_kl": int(sampled)}


def expected_norm_source_step_launches(net, sampled: bool) -> dict:
    """``expected_source_step_launches`` on the norm route: the same convs
    and bridges, plus one norm_stats, norm_apply, norm_bwd_sums and
    norm_bwd_dx per norm (after every conv but the head; nothing is
    frozen)."""
    from vae_segmentation_tpu_torch.models.blocks import Conv3

    n = _count(net, Conv3) - 1
    return {**expected_source_step_launches(net, sampled), "norm_stats": n,
            "norm_apply": n, "norm_bwd_sums": n, "norm_bwd_dx": n}


def scaled(counts: dict, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


def added(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in KERNEL_NAMES}


def read_scores(work: str, prefix: str, epochs) -> list:
    out = []
    for epoch in epochs:
        path = os.path.join(work, "tensorboard", prefix,
                            f"score_{epoch}.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
    return out


def saved_checkpoints(work: str, prefix: str) -> list:
    return [n for n in ("best_model.ckpt", "model_epoch1.ckpt",
                        "model_epoch2.ckpt")
            if os.path.exists(os.path.join(work, "3dmodel", prefix, n))]


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
    from vae_segmentation_tpu_torch import train as T
    from vae_segmentation_tpu_torch.cli import source_main, target_main
    from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
    from vae_segmentation_tpu_torch.data import augment
    from vae_segmentation_tpu_torch.data.pipeline import (
        CaseDataset, intensity_normalize)
    from vae_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)
    from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
    from vae_segmentation_tpu_torch.models import Joint, ShapeVAE
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
        save_checkpoint(os.path.join(work, "3dmodel", "smoke_seg",
                                     "best_model.ckpt"),
                        epoch=0, model=model.Seg)
        model = model.to("cuda").eval()
        with open(manifest) as f:
            entries = json.load(f)["NIH_val"]
        case = CaseDataset(entries, data, parse_pan_index("1"))[0]
        image = intensity_normalize(
            torch.from_numpy(case["image"]).cuda())[None, ..., None]
        label = torch.from_numpy(case["label"]).cuda()[None]

        cwd = os.getcwd()

        # ---- what each route runs: the default route in phases 3-11, the
        # opt-in routes again in phases 12 and 13

        def run_cli(fn, argv):
            """fn(argv) from the work directory: its result, its seconds and
            the launches it made."""
            ops.reset_launch_counts()
            os.chdir(work)
            try:
                t0 = time.time()
                best = fn(argv)
                torch.cuda.synchronize()
                return best, time.time() - t0, ops.launch_counts()
            finally:
                os.chdir(cwd)

        def record_checked(run, expected, phase, what):
            """run() on the plain path with every kernel call recorded: the
            calls per kernel against `expected`, then every call held against
            its plain version (check_step_calls). Returns run()'s result, the
            per-kernel totals and the calls."""
            calls = []
            with plain_ops(record=calls):
                out = run()
            torch.cuda.synchronize()
            got = count_calls(calls)
            if got != expected:
                failures.append(f"kernel calls per {what} {got} != {expected}")
            return out, check_step_calls(torch, calls, log, failures,
                                         phase=phase), calls

        def eval_path(prefix, per_fwd, phase, prof_phase, extra=None):
            """Phases 3-4 and 12: the eval CLI --test_only on the synthetic
            cases (per_fwd launches a case, a Dice in [0, 1] each), then one
            Joint forward on the kernel path against the plain path:
            launches per_fwd, finite outputs of the expected shapes, Dice
            within 0.01, and the probabilities' mean abs difference within
            DRIFT_MULTIPLE times the plain path's own drift under reordered
            f32 sums (the paths differ only in f32 summation order, and a
            random-weight Joint amplifies the resulting one-ulp bf16 flips
            layer by layer); forward_ms; then a profiled forward. Returns
            the CLI's launches and forward_ms."""
            dsc, cli_s, launches = run_cli(target_main.main, [
                prefix, "--method", "domain_adaptation", "--test_only",
                "--load_prefix_joint", "smoke", "--save_root",
                os.path.join(work, "3dmodel"), "--val_list", "NIH_val",
                "--val_data_root", data, "--data_path", manifest,
                "--val_batch", "1", "--device", "cuda"])
            want = scaled(per_fwd, args.cases)
            scores = (read_scores(work, prefix, (0,)) or [{}])[0]
            with torch.no_grad():
                ops.reset_launch_counts()
                pred_k, recon_k, mean_k, std_k = model(image)
                fwd_launches = ops.launch_counts()
                pred_k2, recon_k2 = model(image)[:2]
                with plain_ops():
                    pred_p, recon_p, mean_p, std_p = model(image)
                    plain_fwd_ms = forward_ms(torch, model, image, reps=3)
                with plain_ops(reordered=True):
                    pred_r, recon_r = model(image)[:2]
                onehot = L.one_hot_label(label, 2)
                dice = [L.avg_dsc(p_, onehot, binary=True, botindex=1,
                                  topindex=2, return_mean=False).item()
                        for p_ in (pred_k, pred_p)]
            fwd_ms = forward_ms(torch, model, image)
            pred_d = (pred_k.float() - pred_p.float()).abs()
            recon_d = (recon_k.float() - recon_p.float()).abs()
            drift = {n_: {"kernel_vs_plain": _mean_abs(k_, p_),
                          "plain_vs_reordered": _mean_abs(p_, r_),
                          "kernel_vs_kernel": _mean_abs(k_, k2_)}
                     for n_, k_, k2_, p_, r_ in (
                         ("pred", pred_k, pred_k2, pred_p, pred_r),
                         ("recon", recon_k, recon_k2, recon_p, recon_r))}
            finite = all(bool(torch.isfinite(t_.float()).all())
                         for t_ in (pred_k, recon_k, mean_k, std_k))
            shapes_ok = tuple(pred_k.shape) == (1, 128, 128, 128, 2) and \
                tuple(recon_k.shape) == (1, 128, 128, 128, 2) and \
                tuple(mean_k.shape) == (1, 128)
            cli_ok = (launches == want and len(scores) == args.cases
                      and all(0.0 <= v <= 1.0 for v in scores.values()))
            fwd_ok = (fwd_launches == per_fwd and finite and shapes_ok
                      and abs(dice[0] - dice[1]) <= 0.01
                      and all(d_["kernel_vs_plain"]
                              <= DRIFT_MULTIPLE * d_["plain_vs_reordered"]
                              for d_ in drift.values()))
            if not cli_ok:
                failures.append(f"{phase}: eval CLI launches {launches} "
                                f"(want {want}), scores {scores}")
            if not fwd_ok:
                failures.append(f"{phase}: the Joint forward with kernels "
                                "disagrees with the plain path")
            emit({"phase": phase, "cases": args.cases, "cli_s": cli_s,
                  "mean_dice": dsc, "scores": scores, "launches": launches,
                  "launches_expected": want,
                  "launches_per_forward": fwd_launches,
                  "forward_ms": fwd_ms, "plain_forward_ms": plain_fwd_ms,
                  "pred_max_abs_err": pred_d.max().item(),
                  "pred_mean_abs_err": pred_d.mean().item(),
                  "recon_max_abs_err": recon_d.max().item(),
                  "recon_mean_abs_err": recon_d.mean().item(),
                  "mean_rel_err": ((mean_k - mean_p).abs().max()
                                   / mean_p.abs().max()).item(),
                  "std_rel_err": ((std_k - std_p).abs().max()
                                  / std_p.abs().max().clamp_min(1e-30)
                                  ).item(),
                  "mean_abs_drift": drift, "drift_multiple": DRIFT_MULTIPLE,
                  "dice_kernels": dice[0], "dice_plain": dice[1],
                  "finite": finite, "shapes_ok": shapes_ok, **(extra or {}),
                  "ok": cli_ok and fwd_ok}, log)
            del pred_k, recon_k, pred_k2, recon_k2, pred_p, recon_p, \
                pred_r, recon_r, pred_d, recon_d
            emit(profile_forward(torch, model, image, phase=prof_phase), log)
            return launches, fwd_ms

        # ---- 2. every kernel at every main-path shape
        calls = record_calls(torch, model, image)
        per_fwd = {}
        for c in calls:
            per_fwd[c["key"][0]] = per_fwd.get(c["key"][0], 0) + 1
        if per_fwd != PER_FORWARD:
            failures.append(f"calls per Joint forward {per_fwd}")
        totals = check_kernel_calls(torch, calls, log, failures)
        emit({"phase": "divergence",
              "calls": divergence(torch, model, image, calls)}, log)
        del calls

        # ---- 3-4. the main path through the port's CLI, the Joint forward
        # against the plain path, and where its device time goes
        fwd_want = {**{k: 0 for k in KERNEL_NAMES}, **PER_FORWARD}
        eval_launches, fwd_ms = eval_path("smoke", fwd_want, "main_path",
                                          "profile")

        # ---- 5. every kernel call of one adaptation train step
        train_data = os.path.join(work, "data_train")
        with open(write_synthetic_dataset(
                train_data, n_train=2 * TRAIN_BATCH, n_val=0, size=128,
                seed=args.seed + 1)) as f:
            train_entries = json.load(f)["NIH_train"]
        lists = os.path.join(work, "lists.json")
        with open(lists, "w") as f:
            json.dump({"NIH_train": train_entries, "NIH_val": entries}, f)
        train_ds = CaseDataset(train_entries, train_data,
                               parse_pan_index("1"))
        train_cases = [train_ds[i] for i in range(2 * TRAIN_BATCH)]
        batches = []
        for i in range(0, len(train_cases), TRAIN_BATCH):
            part = train_cases[i:i + TRAIN_BATCH]
            batches.append((
                intensity_normalize(torch.stack(
                    [torch.from_numpy(c["image"]) for c in part]).cuda()),
                torch.stack([torch.from_numpy(c["label"])
                             for c in part]).cuda()))
        state0 = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        step = T.make_adapt_step(T.AdaptConfig(
            n_class=2, domain_loss_type=8, vae_mont_number=1))
        # the pseudo-label loss alone: its gradient stays inside the Seg
        seg_step = T.make_adapt_step(T.AdaptConfig(n_class=2,
                                                   only_pseudo=True))
        sched = T.default_sched(TRAIN_LAMBDA)

        def fresh(lr=TRAIN_LR):
            """(student, teacher, optimizer, dropout generator) at the seed
            weights: SGD momentum 0.9 on the Seg, the VAE frozen."""
            kw = dict(n_class=2, dim=128, bottleneck=16384)
            student = Joint(vae_decoder_dropout=0.5, **kw).to("cuda")
            teacher = Joint(**kw).to("cuda")
            for net in (student, teacher):
                net.load_state_dict(state0)
            for p_ in teacher.parameters():
                p_.requires_grad_(False)
            opt = T.optim.sgd(T.optim.freeze_vae(student), lr)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            return student, teacher, opt, gen

        def step1(step_fn=step):
            """Loss terms and gradients of step 1 from the seed weights,
            with the same batch and dropout masks on every path. The
            learning rate is 0, so that the weights a recorded call holds
            stay the ones it ran with."""
            student, teacher, opt, gen = fresh(lr=0.0)
            aux = step_fn(student, teacher, opt, *batches[0], gen, sched)
            grads = {k: p_.grad.detach().clone()
                     for k, p_ in student.named_parameters()
                     if p_.grad is not None}
            torch.cuda.synchronize()
            return {k: v.item() for k, v in aux.items()}, grads

        def pseudo_gate():
            """Phases 6 and 12: the pseudo-label loss's step-1 gradient, its
            gradient staying inside the Seg (with random weights the full
            loss's gradient, which crosses the VAE, is decorrelated by any
            f32 reordering: relative L2 error near sqrt 2 on every path), on
            the kernel path against the plain path (drift_ratios)."""
            with plain_ops(reordered=True):
                seg_r = step1(seg_step)[1]
            with plain_ops():
                seg_p = step1(seg_step)[1]
            seg_k = step1(seg_step)[1]
            return drift_ratios(seg_k, seg_p, seg_r)

        def adapt_steps(phase, expected, prof_phase, extra=None,
                        extra_ok=True):
            """Phases 6 and 12: 3 adaptation steps from the seed weights:
            launches `expected` a step, finite losses, the Seg moved, the
            VAE and the teacher not, every module handing its kernel the
            current weight (also after a write through ``weight.data``), the
            EMA update; step_ms, enqueue_ms, peak memory; then a profiled
            step. Returns the record and each step's launches."""
            student, teacher, opt, gen = fresh()
            stale = []
            run = timed_steps(
                torch, ops, lambda i: step(student, teacher, opt,
                                           *batches[i % 2], gen, sched),
                after_first=lambda: stale.extend(
                    stale_kernel_weights(torch, student, teacher)))
            now = student.state_dict()
            seg_moved = all(not torch.equal(v, state0[k])
                            for k, v in now.items()
                            if k.startswith("Seg.") and k.endswith(".weight"))
            vae_still = all(torch.equal(v, state0[k]) for k, v in now.items()
                            if k.startswith("Vae."))
            teacher_still = all(torch.equal(v, state0[k])
                                for k, v in teacher.state_dict().items())
            alpha = 0.995
            T.ema_update_seg(teacher, student, alpha)
            ema_ok = all(
                torch.allclose(v, alpha * state0[k] + (1 - alpha) * now[k],
                               rtol=1e-6, atol=1e-8)
                and not torch.equal(v, state0[k]) if k.endswith(".weight")
                and k.startswith("Seg.") else
                (k.startswith("Seg.") or torch.equal(v, state0[k]))
                for k, v in teacher.state_dict().items())
            stale += stale_kernel_weights(torch, student, teacher)
            ok = (all(c == expected for c in run["launches"])
                  and run["finite"] and seg_moved and vae_still
                  and teacher_still and ema_ok and not stale and extra_ok)
            if not ok:
                failures.append(f"{phase}: the 3 adaptation steps failed a "
                                "check")
            rec = {"phase": phase, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
                   "step_ms": run["step_ms"],
                   "step_ms_all": run["step_ms_all"],
                   "enqueue_ms": run["enqueue_ms"], "losses": run["losses"],
                   "launches_per_step": run["launches"],
                   "launches_expected": expected,
                   "peak_memory_bytes": run["peak_memory_bytes"],
                   "finite": run["finite"], "seg_moved": seg_moved,
                   "vae_unchanged": vae_still,
                   "teacher_unchanged_before_ema": teacher_still,
                   "ema_moved_teacher_seg_only": ema_ok,
                   "stale_kernel_weights": stale, **(extra or {}), "ok": ok}
            emit(rec, log)
            profile_step(torch, lambda: step(student, teacher, opt,
                                             *batches[0], gen, sched),
                         rec["step_ms"], prof_phase, log)
            del student, teacher, opt
            torch.cuda.empty_cache()
            return rec, run["launches"]

        expected_step = expected_step_launches(model)
        (aux_p, grads_p), step_totals, calls = record_checked(
            step1, expected_step, "step_kernel", "train step")
        del calls
        torch.cuda.empty_cache()

        # ---- 6. the train path
        with plain_ops(reordered=True):
            aux_r, grads_r = step1()
        seg_err, seg_drift, seg_worst = pseudo_gate()
        ops.reset_launch_counts()
        aux_k, grads_k = step1()
        step1_launches = ops.launch_counts()
        loss_keys = ("recon_loss", "dice_loss_fake", "dice_loss",
                     "final_loss")
        loss_err = {k: abs(aux_k[k] - aux_p[k]) for k in loss_keys}
        loss_drift = {k: abs(aux_r[k] - aux_p[k]) for k in loss_keys}
        # a scalar's drift can be small by chance: hold each term to the
        # largest drift among the terms, and to 1e-3 at least
        loss_gate = max(DRIFT_MULTIPLE * max(loss_drift.values()), 1e-3)
        err, drift, worst = drift_ratios(grads_k, grads_p, grads_r)
        # the backward alone, across the frozen VAE: one student forward on
        # the kernel path, then the reconstruction Dice's backward (pred
        # detached on its own side, so the gradient reaches the Seg only
        # through the VAE) three times on that one graph. With the saved
        # activations and masks fixed the backward is one linear map, so
        # this gate is well conditioned where the whole step's is not.
        student, _, _, gen = fresh(lr=0.0)
        pred, recon = student(batches[0][0][..., None], dropout=True,
                              generator=gen)[:2]
        recon_loss = 1.0 - L.multi_soft_dice(
            pred.detach(), (recon,), eps=L.EVAL_EPS)[0][:, 1:2].mean()
        names, params = zip(*[(k, p_) for k, p_ in student.named_parameters()
                              if p_.requires_grad])

        def backward():
            grads = torch.autograd.grad(recon_loss, params, retain_graph=True)
            torch.cuda.synchronize()
            return dict(zip(names, grads))

        ops.reset_launch_counts()
        bwd_k = backward()
        bwd_launches = ops.launch_counts()
        bwd_expected = expected_backward_launches(model)
        with plain_ops():
            bwd_p = backward()
        with plain_ops(reordered=True):
            bwd_r = backward()
        bwd_err, bwd_drift, bwd_worst = drift_ratios(bwd_k, bwd_p, bwd_r)
        bwd_ok = (bwd_launches == bwd_expected
                  and all(k.startswith("Seg.") for k in names)
                  and all(bool(torch.isfinite(g).all())
                          and (bool(g.any()) or not k.endswith(".weight"))
                          for k, g in bwd_k.items())
                  and all(v <= DRIFT_MULTIPLE for v in bwd_worst.values()))
        del student, pred, recon, recon_loss, params, bwd_k, bwd_p, bwd_r
        step1_ok = (
            step1_launches == expected_step and bwd_ok
            and sorted(grads_k) == sorted(grads_p)
            and all(k.startswith("Seg.") for k in grads_k)
            and all(bool(torch.isfinite(g).all()) for g in grads_k.values())
            and all(v <= loss_gate for v in loss_err.values())
            and all(v <= DRIFT_MULTIPLE for v in worst.values())
            and all(v <= DRIFT_MULTIPLE for v in seg_worst.values()))
        if not step1_ok:
            failures.append("train step 1 with kernels disagrees with the "
                            "plain path")
        emit({"phase": "train_step1", "launches": step1_launches,
              "launches_expected": expected_step, "losses_kernels": aux_k,
              "losses_plain": aux_p, "losses_reordered": aux_r,
              "loss_err": loss_err, "loss_drift": loss_drift,
              "loss_gate": loss_gate, "grad_tensors": len(err),
              "grad_rel_l2_kernel_vs_plain": err,
              "grad_rel_l2_plain_vs_reordered": drift,
              "worst_ratio": max(worst.values()),
              "median_ratio": sorted(worst.values())[len(worst) // 2],
              "pseudo_only_grad_rel_l2_kernel_vs_plain": seg_err,
              "pseudo_only_grad_rel_l2_plain_vs_reordered": seg_drift,
              "pseudo_only_worst_ratio": max(seg_worst.values()),
              "vae_backward_launches": bwd_launches,
              "vae_backward_launches_expected": bwd_expected,
              "vae_backward_grad_rel_l2_kernel_vs_plain": bwd_err,
              "vae_backward_grad_rel_l2_plain_vs_reordered": bwd_drift,
              "vae_backward_worst_ratio": max(bwd_worst.values()),
              "vae_backward_ok": bwd_ok,
              "drift_multiple": DRIFT_MULTIPLE, "ok": step1_ok}, log)
        del grads_p, grads_r, grads_k

        adapt_rec, step_launches = adapt_steps("train_steps", expected_step,
                                               "profile_step")

        # two outer epochs of the CLI's training loop: the first takes no
        # step, the second one step per batch after one EMA update
        best, train_cli_s, cli_launches = run_cli(target_main.main, [
            "smoke_train", "--method", "domain_adaptation", "--no_aug",
            "--load_prefix", "smoke_seg", "--load_prefix_vae", "smoke",
            "--save_root", os.path.join(work, "3dmodel"),
            "--train_list", "NIH_train",
            "--val_list", "NIH_val", "--data_root", train_data,
            "--val_data_root", data, "--data_path", lists,
            "-b", str(TRAIN_BATCH), "--val_batch", "1",
            "--eval_epoch", "1", "--save_epoch", "1", "--max_epoch", "2",
            "--num_workers", "2", "--domain_loss_type", "8",
            "--lambda_vae", str(TRAIN_LAMBDA), "--lr_seg", str(TRAIN_LR),
            "--vae_decoder_dropout", "0.5", "--pseudo_save_epoch", "1",
            "--device", "cuda"])
        cli_steps = len(train_cases) // TRAIN_BATCH
        cli_expected = {
            k: cli_steps * expected_step[k]
            + 2 * args.cases * PER_FORWARD.get(k, 0) for k in KERNEL_NAMES}
        epoch_scores = read_scores(work, "smoke_train", (0, 1))
        saved = saved_checkpoints(work, "smoke_train")
        cli_ok = (cli_launches == cli_expected and len(epoch_scores) == 2
                  and all(len(sc) == args.cases
                          and all(0.0 <= v <= 1.0 for v in sc.values())
                          for sc in epoch_scores)
                  and len(saved) == 3 and 0.0 <= best <= 1.0)
        if not cli_ok:
            failures.append("the CLI's training loop failed a check")
        emit({"phase": "train_cli", "seconds": train_cli_s, "steps": cli_steps,
              "best_dice": best, "scores": epoch_scores, "saved": saved,
              "launches": cli_launches, "launches_expected": cli_expected,
              "ok": cli_ok}, log)
        train_launches = added(cli_launches, *step_launches)

        # ---- 7. the reparam kernel at the vae_train shape
        reparam_totals = check_reparam(torch, args.seed, log, failures)

        # ---- 8. every kernel call of one vae_train step (batch 4, 128^3)
        src_data = os.path.join(work, "data_source")
        with open(write_synthetic_dataset(
                src_data, n_train=VAE_BATCH, n_val=0, size=128,
                seed=args.seed + 3)) as f:
            src_entries = json.load(f)["NIH_train"]
        src_lists = os.path.join(work, "lists_source.json")
        with open(src_lists, "w") as f:
            json.dump({"NIH_train": src_entries, "NIH_val": entries}, f)
        src_ds = CaseDataset(src_entries, src_data, parse_pan_index("1"))
        src_cases = [src_ds[i] for i in range(VAE_BATCH)]
        src_img = torch.stack([torch.from_numpy(c["image"])
                               for c in src_cases]).cuda()
        src_lab = torch.stack([torch.from_numpy(c["label"])
                               for c in src_cases]).cuda()
        aug_gen = torch.Generator(device="cuda").manual_seed(args.seed)
        patch = (128, 128, 128)
        warp_ms = cuda_ms(torch, lambda: augment.spatial_augment(
            src_img, src_lab, aug_gen, patch_size=patch), max_reps=10)
        # the step's batches: the ground truth of 4 cases, warped
        vae_batches = [augment.spatial_augment(src_img, src_lab, aug_gen,
                                               patch_size=patch)[1]
                       for _ in range(2)]
        warp_ok = all(set(b.unique().tolist()) <= {0.0, 1.0}
                      and bool(b.any()) for b in vae_batches)
        vae0 = ShapeVAE(n_class=2, dim=128, bottleneck=16384,
                        generator=torch.Generator().manual_seed(args.seed + 2))
        vstate0 = {k: v.detach().cuda() for k, v in vae0.state_dict().items()}
        vae_step = T.make_vae_train_step(2, scale=VAE_SCALE)

        def vae_fresh(lr):
            """(ShapeVAE at the seed weights, SGD momentum 0.9 on all of
            it, the generator of the reparam seeds)."""
            vae = ShapeVAE(n_class=2, dim=128, bottleneck=16384).cuda()
            vae.load_state_dict(vstate0)
            return vae, T.optim.sgd(vae.parameters(), lr), \
                torch.Generator(device="cuda").manual_seed(args.seed)

        def vae_step1():
            """Loss terms and gradients of a vae_train step 1 at lr 0 (the
            weights a recorded call holds stay the ones it ran with), with
            the same batch and reparam seed on every path."""
            vae, opt, gen = vae_fresh(0.0)
            aux = vae_step(vae, opt, vae_batches[0], gen)
            grads = {k: p_.grad.detach().clone()
                     for k, p_ in vae.named_parameters()}
            torch.cuda.synchronize()
            return {k: v.item() for k, v in aux.items()}, grads

        def vae_steps(phase, expected, prof_phase, extra=None,
                      extra_ok=True):
            """Phases 10, 12 and 13: 3 vae_train steps from the seed weights
            (SGD at VAE_LR on all of the VAE): launches `expected` a step,
            finite losses, every weight moved but the norm-cancelled biases;
            step_ms, enqueue_ms, peak memory; then a profiled step. Returns
            the record and each step's launches."""
            vae, opt, gen = vae_fresh(VAE_LR)
            run = timed_steps(torch, ops, lambda i: vae_step(
                vae, opt, vae_batches[i % 2], gen))
            moved = {k: not torch.equal(v, vstate0[k])
                     for k, v in vae.state_dict().items()}
            moved_ok = all(m for k, m in moved.items()
                           if not norm_cancelled(k))
            ok = (all(c == expected for c in run["launches"])
                  and run["finite"] and moved_ok and extra_ok)
            if not ok:
                failures.append(f"{phase}: the 3 vae_train steps failed a "
                                "check")
            rec = {"phase": phase, "batch": VAE_BATCH, "lr": VAE_LR,
                   "scale": VAE_SCALE, "step_ms": run["step_ms"],
                   "step_ms_all": run["step_ms_all"],
                   "enqueue_ms": run["enqueue_ms"], "losses": run["losses"],
                   "launches_per_step": run["launches"],
                   "launches_expected": expected,
                   "peak_memory_bytes": run["peak_memory_bytes"],
                   "finite": run["finite"], "tensors": len(moved),
                   "moved": sum(moved.values()),
                   "norm_cancelled_biases": sum(map(norm_cancelled, moved)),
                   "norm_cancelled_biases_moved": sum(
                       m for k, m in moved.items() if norm_cancelled(k)),
                   "every_weight_moved": moved_ok, **(extra or {}), "ok": ok}
            emit(rec, log)
            profile_step(torch, lambda: vae_step(vae, opt, vae_batches[0],
                                                 gen),
                         rec["step_ms"], prof_phase, log)
            del vae, opt
            torch.cuda.empty_cache()
            return rec, run["launches"]

        vexpected = expected_source_step_launches(vae0, sampled=True)
        (vaux_p, vgrads_p), vae_totals, calls = record_checked(
            vae_step1, vexpected, "vae_step_kernel", "vae_train step")
        # phase 13's kernel check: conv3_bwd on these calls' dx/dk pairs,
        # run now so that the recording is not held through phases 9-12
        # (their peak memory)
        vae_merged = merged_calls(calls)
        if len(vae_merged) != vexpected["conv3_dk"] - 1:
            failures.append(f"merged backward: {len(vae_merged)} dx/dk pairs "
                            f"in the vae_train step")
        merged_totals = check_step_calls(torch, vae_merged, log, failures,
                                         phase="merged_bwd_kernel")
        del calls, vae_merged
        torch.cuda.empty_cache()

        # ---- 9. the vae_train step-1 gradient gate
        with plain_ops(reordered=True):
            vaux_r, vgrads_r = vae_step1()
        # the loss terms' noise, from the plain path alone: besides the
        # conv sums split by channels, three more orders with the norm
        # statistics' partial sums also added in a shuffled order. K1 adds
        # those partials with atomics, in another order on every run, and
        # the chaotic random-weight encoder carries that into the KL term
        # (kernel vs plain 0.07-1.04% over eight runs of unchanged code on
        # an H100, the conv-split sample alone 0.19-0.23%). Each term is
        # held to its own largest drift over the four orders, and to 1e-3
        # at least
        vaux_s = []
        for seed in (1, 2, 3):
            with plain_ops(reordered=True, stats_seed=seed):
                vaux_s.append(vae_step1()[0])
        ops.reset_launch_counts()
        vaux_k, vgrads_k = vae_step1()
        vstep1_launches = ops.launch_counts()
        vloss_err = {k: abs(vaux_k[k] - vaux_p[k]) / abs(vaux_p[k])
                     for k in vaux_p}
        vloss_orders = [{k: abs(a[k] - vaux_p[k]) / abs(vaux_p[k])
                         for k in vaux_p} for a in (vaux_r, *vaux_s)]
        vloss_drift = {k: max(o[k] for o in vloss_orders) for k in vaux_p}
        vloss_gate = {k: max(DRIFT_MULTIPLE * v, 1e-3)
                      for k, v in vloss_drift.items()}
        verr, vdrift, vworst = drift_ratios(vgrads_k, vgrads_p, vgrads_r)
        # the backward alone on one kernel-path forward's graph: with the
        # saved activations and the sampled eps fixed it is one linear map
        vae, _, gen = vae_fresh(0.0)
        onehot = L.one_hot_label(vae_batches[0], 2)
        latent, klv = vae.reparameterize(*vae.encode(onehot), VAE_SCALE, gen)
        vloss = 1.0 - L.avg_dsc(vae.decode(latent), onehot, botindex=1,
                                topindex=2, eps=L.SOURCE_EPS) + 2e-5 * klv
        vnames, vparams = zip(*vae.named_parameters())

        def vbackward():
            grads = torch.autograd.grad(vloss, vparams, retain_graph=True)
            torch.cuda.synchronize()
            return dict(zip(vnames, grads))

        ops.reset_launch_counts()
        vb_k = vbackward()
        vb_launches = ops.launch_counts()
        vfwd = forward_launches(vae0)
        vb_expected = {k: vexpected[k] - vfwd[k] for k in KERNEL_NAMES}
        vb_expected["reparam_kl"] = 0
        with plain_ops():
            vb_p = vbackward()
        with plain_ops(reordered=True):
            vb_r = vbackward()
        vb_err, vb_drift, vb_worst = drift_ratios(vb_k, vb_p, vb_r)
        vb_ok = (vb_launches == vb_expected
                 and all(bool(torch.isfinite(g).all()) for g in vb_k.values())
                 and all(v <= DRIFT_MULTIPLE for v in vb_worst.values()))
        del vae, latent, klv, vloss, vparams, vb_k, vb_p, vb_r, onehot
        vstep1_ok = (
            vstep1_launches == vexpected and vb_ok
            and sorted(vgrads_k) == sorted(vgrads_p)
            and all(bool(torch.isfinite(g).all()) for g in vgrads_k.values())
            and all(vloss_err[k] <= vloss_gate[k] for k in vloss_err)
            and all(v <= DRIFT_MULTIPLE for v in vworst.values()))
        if not vstep1_ok:
            failures.append("vae_train step 1 with kernels disagrees with "
                            "the plain path")
        emit({"phase": "vae_step1", "batch": VAE_BATCH, "scale": VAE_SCALE,
              "launches": vstep1_launches, "launches_expected": vexpected,
              "losses_kernels": vaux_k, "losses_plain": vaux_p,
              "losses_reordered": vaux_r, "losses_stats_shuffled": vaux_s,
              "loss_rel_err": vloss_err, "loss_rel_drift": vloss_drift,
              "loss_rel_drift_by_order": vloss_orders,
              "loss_gate": vloss_gate, "grad_tensors": len(verr),
              "grad_rel_l2_kernel_vs_plain": verr,
              "grad_rel_l2_plain_vs_reordered": vdrift,
              "worst_ratio": max(vworst.values()),
              "worst_tensor": max(vworst, key=vworst.get),
              "median_ratio": sorted(vworst.values())[len(vworst) // 2],
              "backward_launches": vb_launches,
              "backward_launches_expected": vb_expected,
              "backward_grad_rel_l2_kernel_vs_plain": vb_err,
              "backward_grad_rel_l2_plain_vs_reordered": vb_drift,
              "backward_worst_ratio": max(vb_worst.values()),
              "backward_ok": vb_ok, "drift_multiple": DRIFT_MULTIPLE,
              "ok": vstep1_ok}, log)
        del vgrads_p, vgrads_r, vgrads_k
        torch.cuda.empty_cache()

        # ---- 10. three vae_train steps
        vae_rec, vlaunches = vae_steps(
            "vae_train_steps", vexpected, "profile_vae_step",
            {"warp_ms": warp_ms, "warped_labels_binary": warp_ok}, warp_ok)

        # ---- 11. the chain through the CLIs with the warp on: vae_train,
        # seg_train (no step in the first outer epoch), then the target CLI
        # adapting from their two checkpoints
        src_argv = ["--save_root", os.path.join(work, "3dmodel"),
                    "--train_list", "NIH_train", "--val_list", "NIH_val",
                    "--data_root", src_data, "--val_data_root", data,
                    "--data_path", src_lists, "--val_batch", "1",
                    "--eval_epoch", "1", "--save_epoch", "1",
                    "--max_epoch", "2", "--num_workers", "2",
                    "--device", "cuda"]
        seg_fwd = forward_launches(model.Seg)
        seg_expected = expected_source_step_launches(model.Seg, sampled=False)
        evals = 2 * args.cases          # two outer epochs, one crop a case
        chain = {
            "smoke_vae": (source_main.main, [
                "smoke_vae", "--method", "vae_train", "-b", str(VAE_BATCH),
                "--lr_seg", str(VAE_LR), *src_argv],
                added(scaled(vexpected, 2), scaled(vfwd, evals))),
            "smoke_seg": (source_main.main, [
                "smoke_seg", "--method", "seg_train", "-b", str(VAE_BATCH),
                "--lr_seg", str(VAE_LR), *src_argv],
                added(seg_expected, scaled(seg_fwd, evals))),
            "smoke_adapt": (target_main.main, [
                "smoke_adapt", "--method", "domain_adaptation",
                "--load_prefix", "smoke_seg", "--load_prefix_vae",
                "smoke_vae", "-b", str(TRAIN_BATCH), "--domain_loss_type",
                "8", "--lambda_vae", str(TRAIN_LAMBDA), "--lr_seg",
                str(TRAIN_LR), "--vae_decoder_dropout", "0.5",
                "--pseudo_save_epoch", "1", *src_argv],
                added(scaled(expected_step, VAE_BATCH // TRAIN_BATCH),
                      {k: evals * PER_FORWARD.get(k, 0)
                       for k in KERNEL_NAMES})),
        }
        chain_rec, chain_ok = {}, True
        chain_launches = {k: 0 for k in KERNEL_NAMES}
        for prefix, (fn, argv, want_launches) in chain.items():
            best, secs, got = run_cli(fn, argv)
            scores = read_scores(work, prefix, (0, 1))
            saved = saved_checkpoints(work, prefix)
            ok = (got == want_launches and len(scores) == 2
                  and all(len(sc) == args.cases
                          and all(0.0 <= v <= 1.0 for v in sc.values())
                          for sc in scores)
                  and len(saved) == 3 and 0.0 <= best <= 1.0)
            chain_ok = chain_ok and ok
            chain_launches = added(chain_launches, got)
            chain_rec[prefix] = {"seconds": secs, "best_dice": best,
                                 "scores": scores, "saved": saved,
                                 "launches": got,
                                 "launches_expected": want_launches,
                                 "ok": ok}
        if not chain_ok:
            failures.append("the chain vae_train -> seg_train -> "
                            "domain_adaptation failed a check")
        emit({"phase": "source_chain", "runs": chain_rec, "ok": chain_ok},
             log)
        train_launches = added(train_launches, chain_launches, *vlaunches)

        # ---- 12. the norm route (VAESEG_PALLAS=1): every norm+ReLU through
        # the InstanceNorm kernels on the stored conv output, no stats
        # epilogue, no prologue, no deferred affine; phases 2-6's checks and
        # phase 10's steps on this route
        with route("VAESEG_PALLAS"):
            norm_fwd = {**fwd_want, **PER_NORM_FORWARD}

            def eval_forward():
                with torch.no_grad():
                    model(image)

            _, norm_fwd_totals, calls = record_checked(
                eval_forward, norm_fwd, "norm_fwd_kernel",
                "norm-route Joint forward")
            del calls
            norm_eval_launches, _ = eval_path(
                "smoke_norm", norm_fwd, "norm_main_path", "norm_profile",
                {"default_route_forward_ms": fwd_ms})

            # one adaptation step: every kernel call, forward and backward
            nexpected = expected_norm_step_launches(model)
            _, norm_step_totals, calls = record_checked(
                step1, nexpected, "norm_step_kernel",
                "norm-route train step")
            del calls
            torch.cuda.empty_cache()
            nseg_err, nseg_drift, nseg_worst = pseudo_gate()
            _, nlaunches = adapt_steps(
                "norm_train_steps", nexpected, "norm_profile_step",
                {"default_route_step_ms": adapt_rec["step_ms"],
                 "default_route_enqueue_ms": adapt_rec["enqueue_ms"],
                 "default_route_peak_memory_bytes":
                     adapt_rec["peak_memory_bytes"],
                 "pseudo_only_grad_rel_l2_kernel_vs_plain": nseg_err,
                 "pseudo_only_grad_rel_l2_plain_vs_reordered": nseg_drift,
                 "pseudo_only_worst_ratio": max(nseg_worst.values()),
                 "drift_multiple": DRIFT_MULTIPLE},
                all(v <= DRIFT_MULTIPLE for v in nseg_worst.values()))
            _, nvlaunches = vae_steps(
                "norm_vae_train_steps",
                expected_norm_source_step_launches(vae0, sampled=True),
                "norm_profile_vae_step",
                {"default_route_step_ms": vae_rec["step_ms"],
                 "default_route_enqueue_ms": vae_rec["enqueue_ms"],
                 "default_route_peak_memory_bytes":
                     vae_rec["peak_memory_bytes"]})
        norm_launches = added(norm_eval_launches, *nlaunches, *nvlaunches)

        # ---- 13. the merged conv backward (VAESEG_MERGED_BWD=1): its kernel
        # check ran in phase 8 (conv3_bwd on the recorded backward, each dx
        # conv paired with the conv3_dk call of the same conv, against the
        # pair's plain outputs); now phase 10's steps on the merged route
        mexpected = {**vexpected, "conv3_bwd": vexpected["conv3_dk"] - 1,
                     "conv3_dk": 1,
                     "conv3": vexpected["conv3"] - vexpected["conv3_dk"] + 1}
        with route("VAESEG_MERGED_BWD"):
            _, mlaunches = vae_steps(
                "merged_vae_train_steps", mexpected,
                "merged_profile_vae_step",
                {"pair_route_step_ms": vae_rec["step_ms"],
                 "pair_route_enqueue_ms": vae_rec["enqueue_ms"],
                 "pair_route_peak_memory_bytes":
                     vae_rec["peak_memory_bytes"],
                 "merged_ms_per_step":
                     merged_totals["conv3_bwd"]["kernel_ms"],
                 "pair_ms_per_step": merged_totals["conv3_bwd"]["pair_ms"]})
        merged_launches = added(*mlaunches)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 14. summary lines: K1-K3 per eval forward (phase 2), the backward
    # and loss kernels per adaptation step (phase 5), reparam_kl per
    # vae_train step (phase 7); the kernels of an opt-in route per pass of
    # that route, and their launches counted on its runs: norm_stats and
    # norm_apply per norm-route eval forward (phase 12), norm_bwd_* per
    # norm-route adaptation step (phase 12), conv3_bwd per merged-route
    # vae_train step (phase 13); the norm kernels' launches include the
    # norm-route vae_train steps
    route_of = {**{k: ("VAESEG_PALLAS=1", norm_launches) for k in
                   NORM_KERNELS},
                "conv3_bwd": ("VAESEG_MERGED_BWD=1", merged_launches)}
    kernels = []
    for name in KERNEL_NAMES:
        if name in ("norm_stats", "norm_apply"):
            t, per = norm_fwd_totals[name], \
                "eval forward on the norm route (VAESEG_PALLAS=1), batch 1"
        elif name in NORM_KERNELS:
            t, per = norm_step_totals[name], \
                "adaptation step on the norm route (VAESEG_PALLAS=1), " \
                f"batch {TRAIN_BATCH}"
        elif name == "conv3_bwd":
            t, per = merged_totals[name], \
                "vae_train step on the merged route (VAESEG_MERGED_BWD=1), " \
                f"batch {VAE_BATCH}"
        else:
            t = totals.get(name) or step_totals.get(name) \
                or (reparam_totals if name == "reparam_kl" else {})
            per = "eval forward, batch 1" if name in totals \
                else f"vae_train step, batch {VAE_BATCH}" \
                if name == "reparam_kl" \
                else f"adaptation step, batch {TRAIN_BATCH}"
        source, replaces = SOURCES[name]
        rec = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": t.get("err"),
            "max_rel_err_bf16": t.get("bf16_rel_err"),
            "max_rel_err_f32": t.get("f32_rel_err"),
            "ms": t.get("kernel_ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": "bytes" if t.get("bytes_ms", 0) >= t.get("ops_ms", 0)
            else "operations",
            "library_ms": t.get("library_ms"), "per": per,
            "timed_by": "cuda graph replay" if name in NORM_KERNELS
            else "profiler device time" if name == "reparam_kl"
            else "cuda events"}
        if name in route_of:
            switch, launched = route_of[name]
            rec.update(launches=launched[name], path=switch)
            if "pair_ms" in t:
                rec["pair_ms"] = t["pair_ms"]
            if launched[name] == 0:
                failures.append(f"{name} was never launched on its route "
                                f"({switch})")
        else:
            rec.update(launches=eval_launches[name] + train_launches[name],
                       launches_eval_path=eval_launches[name],
                       launches_train_path=train_launches[name])
            if train_launches[name] == 0 or \
                    (name in PER_FORWARD and eval_launches[name] == 0):
                failures.append(f"{name} was never launched on its main "
                                "path")
        kernels.append(rec)
    emit({"phase": "step_totals", "per_kernel": step_totals}, log)
    emit({"phase": "vae_step_totals", "per_kernel": vae_totals}, log)
    emit({"phase": "norm_totals", "per_forward": norm_fwd_totals,
          "per_step": norm_step_totals}, log)
    emit({"phase": "merged_totals", "per_vae_step": merged_totals}, log)
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
