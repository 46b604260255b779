#!/usr/bin/env python3
"""Time K2's dx (``down_k2s2_bwd`` with dx alone, kernels/csrc/
bridge_bwd.cu) and the InstanceNorm reduction (``norm_stats``,
``norm_bwd_sums``, kernels/csrc/instance_norm.cu) of the port tree at
--root, on one GPU, at the distinct calls a chip_smoke.py run recorded:

    python3 tools/dx_norm_calls.py --calls SMOKE_JSON --root DIR \\
        [--seed 0] [--out PATH]

SMOKE_JSON is chip_smoke.py's --out file. Its per-call records of phases 5
(``step_kernel``: an adaptation step, batch 2), 8 (``vae_step_kernel``: a
vae_train step, batch 4) and 12 (``norm_fwd_kernel``, ``norm_step_kernel``:
the norm route's eval forward and adaptation step) give each distinct call
(shape, options) and its count a pass. For each, inputs drawn from --seed
go through the tree's wrapper, which is held to its plain version (dx
within 1e-2 of max|dx|, K2's (ds, dt) and the norm sums within
chip_smoke.F32_TOL of their largest element) and timed by CUDA events and
as a replayed CUDA graph with the tree's own chip_smoke.py helpers. To
compare two trees on one card, run the tool on each in one call (parent,
change, change, parent). One JSON line a call, then the sums a pass, then
the card's name and power limit. Exits 1 if a call fails its rule.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("step_kernel", "vae_step_kernel", "norm_fwd_kernel",
          "norm_step_kernel")
KERNELS = ("down_k2s2_bwd", "norm_stats", "norm_bwd_sums")


def recorded_calls(path: str) -> list:
    """[(phase, kernel, record)] of the distinct calls to time: K2's
    backward calls that compute dx, every norm reduction call."""
    with open(path) as f:
        records = json.load(f)["records"]
    return [(r["phase"], r["kernel"], r) for r in records
            if r.get("phase") in PHASES and r.get("kernel") in KERNELS
            and (r["kernel"] != "down_k2s2_bwd" or r["need_dx"])]


def rel_err(got, want) -> float:
    """max abs error over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    calls = recorded_calls(args.calls)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("dx_norm_calls: no CUDA GPU is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vae_segmentation_tpu_torch.ops import bridges, instance_norm

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    lines, sums, failed = [], {}, False
    for phase, kernel, r in calls:
        shape = tuple(r["shape"])
        b, c = shape[0], shape[-1]
        if kernel == "down_k2s2_bwd":
            cout = r["cout"]
            x = rnd(*shape).bfloat16()
            gy = rnd(b, *(e // 2 for e in shape[1:4]), cout).bfloat16()
            w = rnd(cout, c, 2, 2, 2, scale=(8 * cout) ** -0.5)
            kw = bridges.down_kernel_weight(w)
            aff = (rnd(b, c).abs() + 0.5, rnd(b, c, scale=0.3)) \
                if r["pre"] else None

            def run():
                return bridges._launch_bwd("down_k2s2_bwd", False, x, gy,
                                           kw, aff, True, False)
            got = run()
            want = bridges.down_k2s2_bwd_plain(x, gy, w, aff)
            errs = [rel_err(got[0], want[0])]
            ok = errs[0] <= 1e-2
            if aff is not None:
                errs.append(rel_err(got[3], want[3]))
                ok = ok and errs[1] <= cs.F32_TOL
        else:
            x = (rnd(*shape) * 3 + 1).bfloat16()
            n = x.numel() // (b * c)
            if kernel == "norm_stats":
                def run():
                    return instance_norm.norm_stats(x)
                want = instance_norm.norm_stats_plain(x)
            else:
                g = rnd(*shape).bfloat16()
                s, t = instance_norm.affine_from_stats(
                    instance_norm.norm_stats_plain(x), n)
                relu = bool(r.get("relu", True))

                def run():
                    return instance_norm.norm_bwd_sums(x, g, s, t, relu)
                want = instance_norm.norm_bwd_sums_plain(x, g, s, t, relu)
            errs = [rel_err(run(), want)]
            ok = errs[0] <= cs.F32_TOL
        rec = {"phase": phase, "kernel": kernel, "shape": list(shape),
               "pre": r.get("pre"), "cout": r.get("cout"),
               "relu": r.get("relu"), "calls": r["calls_per_step"],
               "rel_err": errs, "ok": ok,
               "events_ms": cs.cuda_ms(torch, run),
               "graph_ms": cs.graph_ms(torch, run)}
        failed = failed or not ok
        key = f"{phase}/{kernel}"
        s_ = sums.setdefault(key, {"calls": 0, "events_ms": 0.0,
                                   "graph_ms": 0.0})
        s_["calls"] += rec["calls"]
        for f in ("events_ms", "graph_ms"):
            s_[f] += rec["calls"] * rec[f]
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del x
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"root": root, "sums": sums, "ok": not failed}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"calls": lines, **summary, "card": card}, f, indent=1)
    print(json.dumps(summary))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
