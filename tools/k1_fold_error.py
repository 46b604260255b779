#!/usr/bin/env python3
"""Measure what the length of K1's chains of MMAs does to its f32 sums on
the GPU, and how far K1's and the plain version's stats are from their f64
value: the tensor cores' f32 accumulation truncates, so a chain of mma.sync
drifts toward zero, and kernels/csrc/conv3.cu starts each chain of at most
CONV3_FOLD k16 steps from zero and adds it to an f32 total with a rounded
add.

    python3 tools/k1_fold_error.py [--seeds 3] [--folds 1,2,4,8,0]
                                   [--out PATH]

Each chain length of --folds (0: one chain of all the steps) is a build of
conv3.cu with -DCONV3_FOLD=N (the shipped length is the library the port
builds; the others are built in parallel under .smoke_work/k1_fold). For
main-path K1 shapes (batch, grid, channels and prologue of the calls the
models make) and each chain length, K1 runs on seeded inputs under the
shape's own plan, and prints one JSON line with:
- ``dt_rel_err``: the post epilogue under a mask that passes every voxel
  (xs = 1, scale 1, shift 0) gives dt = sum g, the f32 conv sum added over
  the volume before any bf16 rounding; its largest error against the f64
  sum of the f64 conv (over the f32 xn and the bf16 weight), over sum |g|;
- ``y_flip_rate``: the share of stored bf16 outputs that differ from the
  f64 conv rounded to bf16 once (the plain version's share beside it);
- ``y_mean_signed_rel_err``: their mean error in the direction of |g|
  over mean |g| (a drift toward zero shows as a negative bias);
- ``stats_sum_err`` and ``stats_sumsq_rel``: chip_smoke.py's gate on the
  stats epilogue (sum err over sum |y|, sumsq relative; each at most 1e-3)
  against ``conv3_plain`` on the same inputs, the largest over the seeds;
- ``f64``: the same two measures of K1's stats against the f64 stats, the
  f64 sums of the f64 conv (plus bias) rounded to bf16 once, and against
  the f64 sums of K1's own stored y (``own``: its summation alone), the
  largest over the seeds; the shape's line gives the plain version's
  beside them (``plain_f64``, ``plain_own``);
- ``graph_ms``: the call's device time as a replayed CUDA graph.
The last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys

# (batch, grid, cin, cout, prologue): the deepest convs (432 k16 steps,
# split K), a 8^3 conv under the prologue, two 64^3 ones, the 128^3 entry
# convs
SHAPES = [(4, (4, 4, 4), 256, 256, True),
          (4, (4, 4, 4), 128, 256, False),
          (2, (8, 8, 8), 128, 128, True),
          (4, (64, 64, 64), 16, 16, True),
          (4, (64, 64, 64), 8, 16, False),
          (4, (128, 128, 128), 16, 8, False),
          (4, (128, 128, 128), 8, 8, True)]
ALL = 1 << 30     # a chain longer than any call's k16 steps


def fold_libraries(build, folds, work: str) -> dict:
    """{fold: the conv3 library built with -DCONV3_FOLD=fold}: the port's
    own build for the length conv3.cu ships, the others compiled in
    parallel under `work`."""
    shipped = int(re.search(r"#define CONV3_FOLD (\d+)", (
        build.CSRC / "conv3.cu").read_text()).group(1))
    base = build.library("conv3")
    libs = {f: base for f in folds if f == shipped}
    os.makedirs(work, exist_ok=True)
    procs = {}
    for f in folds:
        if f not in libs:
            out = os.path.join(work, f"libconv3-fold{f}.so")
            procs[f] = (out, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, f"-DCONV3_FOLD={f}",
                 "-o", out, str(build.CSRC / "conv3.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for f, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for fold {f}:\n{log}")
        libs[f] = build._load("conv3", out)
    return libs


@contextlib.contextmanager
def using(build, lib):
    """Within: conv3_launch calls `lib`."""
    saved = build._libs["conv3"]
    build._libs["conv3"] = lib
    try:
        yield
    finally:
        build._libs["conv3"] = saved


def stats_err(st, want, abs_sum) -> tuple:
    """chip_smoke.py's measures of [B, 2, C] stats against `want`: the sum's
    error over sum |y|, the sumsq's relative error."""
    st, want = st.double(), want.double()
    return (((st[:, 0] - want[:, 0]).abs() / abs_sum).max().item(),
            ((st[:, 1] - want[:, 1]).abs()
             / want[:, 1].clamp_min(1e-30)).max().item())


def keep_max(into: dict, got: tuple, prefix: str = "") -> None:
    """Keep the larger of each stats_err measure in `into`."""
    for key, v in zip(("sum_err", "sumsq_rel"), got):
        into[prefix + key] = max(into[prefix + key], v)


def f64_stats(y):
    """[B, 2, C]: the f64 sum and sum of squares of y over its voxels."""
    import torch

    y = y.double()
    return torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                       dim=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--folds", default="1,2,4,8,0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    folds = [int(f) or ALL for f in args.folds.split(",")]

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k1_fold_error: no CUDA GPU is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from vae_segmentation_tpu_torch.ops import conv3
    from vae_segmentation_tpu_torch.ops.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = conv3.sm_count(0)
    libs = fold_libraries(build, folds,
                          os.path.join(root, ".smoke_work", "k1_fold"))
    lines = []
    for b, grid, cin, cout, pre in SHAPES:
        zero = {"sum_err": 0.0, "sumsq_rel": 0.0}
        recs = {f: {"fold": f, "stats_sum_err": 0.0, "stats_sumsq_rel": 0.0,
                    "f64": dict(zero), "own": dict(zero)} for f in folds}
        plain_f64, plain_own = dict(zero), dict(zero)
        for seed in range(args.seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            x = torch.randn(b, *grid, cin, device="cuda",
                            generator=gen).bfloat16()
            w = torch.randn(cout, cin, 3, 3, 3, device="cuda",
                            generator=gen) * (27 * cin) ** -0.5
            bias = torch.randn(cout, device="cuda", generator=gen) * 0.1
            aff = (torch.rand(b, cin, device="cuda", generator=gen) + 0.5,
                   torch.randn(b, cin, device="cuda", generator=gen) * 0.3) \
                if pre else None
            kw = conv3.kernel_weight(w)
            want = conv3.conv3_plain(x, w, bias, aff, stats=True)
            abs_sum = want[0].double().abs().sum(dim=(1, 2, 3))
            first = seed == 0
            xn = x.float() if aff is None else conv3._affine_relu(x, aff)
            ref = F.conv3d(xn.double().permute(0, 4, 1, 2, 3),
                           w.to(torch.bfloat16).double(), padding=1)
            ref = ref.permute(0, 2, 3, 4, 1)
            del xn
            exact = f64_stats((ref + bias.double()).to(torch.bfloat16))
            keep_max(plain_f64, stats_err(want[1], exact, abs_sum))
            keep_max(plain_own, stats_err(want[1], f64_stats(want[0]),
                                          abs_sum))
            if first:
                ones = (torch.ones(b, *grid, cout, device="cuda",
                                   dtype=torch.bfloat16),
                        torch.ones(b, cout, device="cuda"),
                        torch.zeros(b, cout, device="cuda"))
                plain_y = conv3.conv3_plain(x, w, None, aff)
                ref_bf16 = ref.to(torch.bfloat16)
                plain_flips = (plain_y != ref_bf16).float().mean().item()
            plan = conv3.conv3_plan(b, grid, cin, cout, pre, "stats", sms)
            pplan = conv3.conv3_plan(b, grid, cin, cout, pre, "post", sms)
            for fold in folds:
                rec = recs[fold]
                with using(build, libs[fold]):
                    y, st = conv3.conv3_launch(x, kw, bias, plan, aff)
                rec["splits"] = plan["splits"]
                rec["k_steps"] = plan["k_steps"]
                keep_max(rec, stats_err(st, want[1], abs_sum), "stats_")
                keep_max(rec["f64"], stats_err(st, exact, abs_sum))
                keep_max(rec["own"], stats_err(st, f64_stats(y), abs_sum))
                del y, st
                if not first:
                    continue
                with using(build, libs[fold]):
                    rec["graph_ms"] = cs.graph_ms(
                        torch, lambda: conv3.conv3_launch(x, kw, bias, plan,
                                                          aff))
                    g, dst = conv3.conv3_launch(x, kw, None, pplan, aff,
                                                ones)
                rec["dt_rel_err"] = ((dst[:, 1].double()
                                      - ref.sum(dim=(1, 2, 3))).abs()
                                     / ref.abs().sum(dim=(1, 2, 3))
                                     ).max().item()
                rec["y_flip_rate"] = (g != ref_bf16).float().mean().item()
                rec["y_mean_signed_rel_err"] = (
                    ((g.double() - ref) * ref.sign()).mean()
                    / ref.abs().mean()).item()
            torch.cuda.synchronize()
        line = {"batch": b, "grid": list(grid), "cin": cin, "cout": cout,
                "prologue": pre, "seeds": args.seeds,
                "plain_y_flip_rate": plain_flips, "plain_f64": plain_f64,
                "plain_own": plain_own, "folds": [recs[f] for f in folds]}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del x, w, ref, ref_bf16, ones, plain_y, want
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
