#!/usr/bin/env python3
"""Time the InstanceNorm's elementwise passes (``norm_apply``,
``norm_bwd_dx``, kernels/csrc/instance_norm.cu) and ``softmax_vjp``
(kernels/csrc/losses.cu) of the port tree at --root, on one GPU, at the
distinct calls a chip_smoke.py run recorded:

    python3 tools/apply_vjp_calls.py --calls SMOKE_JSON --root DIR \\
        [--seed 0] [--out PATH]

SMOKE_JSON is chip_smoke.py's --out file. Its per-call records of phases 5
(``step_kernel``: an adaptation step, batch 2), 8 (``vae_step_kernel``: a
vae_train step, batch 4) and 12 (``norm_fwd_kernel``, ``norm_step_kernel``:
the norm route's eval forward and adaptation step) give each distinct call
(shape, relu) and its count a pass. For each, inputs drawn from --seed go
through the tree's wrapper, whatever its contract (``norm_apply`` on (s, t)
or on the f64 sums; ``norm_bwd_dx`` on the means or on the f64 sums), held
to its plain version (within 1e-2 of the largest |y|; ``bitwise`` says
whether every bit agrees), and timed by CUDA events and as a replayed CUDA
graph with the tree's own chip_smoke.py helpers. A norm call also times a
whole norm as a graph, the forward (``instance_norm_act``) for
``norm_apply`` and the backward (``norm_bwd``) for ``norm_bwd_dx``, and
counts its device kernels by the profiler (``kernels_a_norm``); a
``softmax_vjp`` call also times ``aten._softmax_backward_data`` as a graph.
To compare two trees on one card, run the tool on each in one call
(parent, change, change, parent). One JSON line a call, then the sums a
pass, then the card's name and power limit. Exits 1 if a call fails its
rule.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

PHASES = ("step_kernel", "vae_step_kernel", "norm_fwd_kernel",
          "norm_step_kernel")
KERNELS = ("norm_apply", "norm_bwd_dx", "softmax_vjp")


def recorded_calls(path: str) -> list:
    """[(phase, kernel, record)] of the distinct calls to time."""
    with open(path) as f:
        records = json.load(f)["records"]
    return [(r["phase"], r["kernel"], r) for r in records
            if r.get("phase") in PHASES and r.get("kernel") in KERNELS]


def kernels_of(torch, fn, reps: int = 3) -> list:
    """The device activities of one fn() call by the profiler's events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    return names[:len(names) // reps]


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
        print("apply_vjp_calls: no CUDA GPU is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vae_segmentation_tpu_torch.ops import instance_norm as N
    from vae_segmentation_tpu_torch.ops import losses

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    # the tree's contract: the fused row 16 takes the f64 sums
    fused = "sums" in inspect.signature(N.norm_apply).parameters
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    lines, sums, failed = [], {}, False
    for phase, kernel, r in calls:
        shape = tuple(r["shape"])
        relu = bool(r.get("relu", True))
        rec = {"phase": phase, "kernel": kernel, "shape": list(shape),
               "relu": r.get("relu"), "calls": r["calls_per_step"]}
        with torch.no_grad():
            if kernel == "softmax_vjp":
                y = torch.softmax(rnd(*shape), dim=-1).bfloat16()
                g = rnd(*shape).bfloat16()

                def run():
                    return losses.softmax_vjp(g, y)
                want = losses.softmax_vjp_plain(g, y)
                rec["library_graph_ms"] = cs.graph_ms(
                    torch, lambda: torch.ops.aten._softmax_backward_data(
                        g, y, -1, torch.bfloat16))
            else:
                b, c = shape[0], shape[-1]
                x = (rnd(*shape) * 3 + 1).bfloat16()
                g = rnd(*shape).bfloat16()
                n = x.numel() // (b * c)
                st64 = N._launch("norm_stats", x, False)
                s, t = N.affine_from_stats(st64.float(), n)
                if kernel == "norm_apply":
                    if fused:
                        def run():
                            return N.norm_apply(x, st64, relu)[0]
                    else:
                        def run():
                            return N.norm_apply(x, s, t, relu)

                    def whole():
                        return N.instance_norm_act(x, relu)
                    want = N.norm_apply_plain(x, s, t, relu)
                else:
                    bs64 = N._launch("norm_bwd_sums", x, relu, g=g,
                                     aff=(s, t))
                    m = bs64.float() / n
                    if fused:
                        def run():
                            return N.norm_bwd_dx(x, g, s, t, bs64, relu)
                    else:
                        def run():
                            return N.norm_bwd_dx(x, g, s, t, m, relu)

                    def whole():
                        return N.norm_bwd(x, g, s, t, relu)
                    gm, xhat = N._masked(x, g, s, t, relu)
                    want = (s[:, None, None, None] * (
                        gm - m[:, None, None, None, 0]
                        - xhat * m[:, None, None, None, 1])).to(x.dtype)
                rec["norm_graph_ms"] = cs.graph_ms(torch, whole)
                names = kernels_of(torch, whole)
                rec["kernels_a_norm"] = len(names)
                rec["kernel_names"] = names
            got = run()
            rec["bitwise"] = bool(torch.equal(got, want))
            err = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max().clamp_min(1e-30)).item()
            rec.update(rel_err=err, ok=err <= 1e-2,
                       events_ms=cs.cuda_ms(torch, run),
                       graph_ms=cs.graph_ms(torch, run))
        failed = failed or not rec["ok"]
        s_ = sums.setdefault(f"{phase}/{kernel}", {"calls": 0})
        s_["calls"] += rec["calls"]
        for f in ("events_ms", "graph_ms", "norm_graph_ms",
                  "library_graph_ms"):
            if f in rec:
                s_[f] = s_.get(f, 0.0) + rec["calls"] * rec[f]
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"root": root, "fused": fused, "sums": sums, "ok": not failed}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"calls": lines, **summary, "card": card}, f, indent=1)
    print(json.dumps(summary))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
