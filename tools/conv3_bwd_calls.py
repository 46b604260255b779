#!/usr/bin/env python3
"""Hold the merged conv backward (``conv3_bwd``, kernels/csrc/conv3_bwd.cu)
to its plain version and time it at every call shape of a vae_train step
on the merged route (VAESEG_MERGED_BWD=1), on one GPU:

    python3 tools/conv3_bwd_calls.py [--batch 4] [--seed 0] [--out PATH]

The call shapes are those of the ShapeVAE at full width on a 128^3 batch
(every conv but the entry one, whose input needs no gradient): a forward
at 32^3 on the CPU records each Conv3's input and options, and the grids
are scaled by 4. For each distinct shape, inputs drawn from --seed (x, a
cotangent with its per-channel mean taken out, as under an InstanceNorm,
the weight, the prologue's affine) go through the kernel and its plain
version under chip_smoke.py's phase-13 rules (dx within 1e-2 of max|dx|,
(ds, dt) within F32_TOL, dk and db against their f64 value), two more
launches must give the same bits, and the call is timed by CUDA events and
as a replayed CUDA graph beside the pair it replaces (K1 as the dx conv,
then conv3_dk) and ``aten.convolution_backward`` with mask (T, T, T)
(bf16, channels_last_3d; a yardstick only, the port never calls it), and
its device time split by kernel (``torch.profiler``: the main kernel, dx's
second pass, the (ds, dt) and dk reductions). One JSON line a shape, with
the plan and the bound (chip_smoke.op_work); the
last two lines are the sums over the step's calls and the card's name and
power limit. Exits 1 if any call fails a rule.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def merged_shapes(batch: int) -> list:
    """[(shape of x, Cout, prologue, calls a step)] of the merged calls of
    a vae_train step at 128^3."""
    import torch

    from vae_segmentation_tpu_torch.models import ShapeVAE
    from vae_segmentation_tpu_torch.models.blocks import Conv3

    vae = ShapeVAE(n_class=2, dim=32, bottleneck=256,
                   generator=torch.Generator().manual_seed(0))
    calls = []

    def hook(module, args, kwargs, out):
        x = args[0]
        pre = kwargs.get("pre", args[1] if len(args) > 1 else None)
        calls.append(((batch, *(4 * e for e in x.shape[1:4]), x.shape[-1]),
                      module.weight.shape[0], pre is not None))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in vae.modules() if isinstance(m, Conv3)]
    with torch.no_grad():
        vae(torch.zeros(1, 32, 32, 32, 2))
    for h in handles:
        h.remove()
    counts = {}
    for c in calls[1:]:             # the entry conv: no dx, conv3_dk alone
        counts[c] = counts.get(c, 0) + 1
    return [(*k, n) for k, n in counts.items()]


def device_ms_by_kernel(torch, fn, reps: int = 5) -> dict:
    """Device ms per call of fn() by kernel (``torch.profiler``): the main
    kernel, dx's second pass, the (ds, dt) and dk reductions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        key = ev.key.replace("(anonymous namespace)::", "")
        name = next((m for m in re.findall(r"(\w+)(?:<[^()]*>)?\(", key)
                     if m != "void"), key)
        out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("conv3_bwd_calls: no CUDA GPU is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from vae_segmentation_tpu_torch.ops import conv3
    from vae_segmentation_tpu_torch.ops.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["conv3", "conv3_dk", "conv3_bwd"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    sms = conv3.sm_count(0)
    lines, failed = [], 0
    total = {f: 0.0 for f in ("kernel_ms", "graph_ms", "pair_ms",
                              "pair_graph_ms", "library_ms",
                              "library_graph_ms", "plain_ms", "bound_ms")}
    total["calls"] = 0
    for shape, cout, pre, n in merged_shapes(args.batch):
        b, cin = shape[0], shape[-1]
        x = torch.randn(*shape, device="cuda", generator=gen).bfloat16()
        g = torch.randn(*shape[:-1], cout, device="cuda", generator=gen)
        gy = (g - g.mean(dim=(1, 2, 3), keepdim=True)).bfloat16()
        del g
        w = torch.randn(cout, cin, 3, 3, 3, device="cuda",
                        generator=gen) * (27 * cin) ** -0.5
        aff = (torch.rand(b, cin, device="cuda", generator=gen) + 0.5,
               torch.randn(b, cin, device="cuda", generator=gen) * 0.3) \
            if pre else None
        a = {"x": x, "gy": gy, "weight": w, "kweight": conv3.kernel_weight(w),
             "pre": aff}
        d = {"kernel": "conv3_bwd", "shape": list(shape), "pre": pre,
             "cout": cout}
        with torch.no_grad():
            got = conv3.conv3_bwd(**a)
            want = conv3.conv3_bwd_plain(x, gy, w, aff)
            rec = cs.compare_call(torch, d, got, want, a)
            rec = cs.exact_compare(torch, "conv3_bwd", a, got, want, rec)
            repeat = cs.repeats_bitwise(torch, lambda: conv3.conv3_bwd(**a),
                                        got)
            del got, want
            kern = lambda: conv3.conv3_bwd(**a)          # noqa: E731
            pair = cs.pair_fn(a)
            lib = cs._library_fn(torch, d, a)
            rec.update(
                kernel_ms=cs.cuda_ms(torch, kern),
                graph_ms=cs.graph_ms(torch, kern),
                pair_ms=cs.cuda_ms(torch, pair),
                pair_graph_ms=cs.graph_ms(torch, pair),
                library_ms=cs.cuda_ms(torch, lib),
                library_graph_ms=cs.graph_ms(torch, lib),
                plain_ms=cs.cuda_ms(torch, lambda: conv3.conv3_bwd_plain(
                    x, gy, w, aff), budget_ms=20.0, max_reps=5))
            rec["device_ms_by_kernel"] = device_ms_by_kernel(torch, kern)
        plan = conv3.conv3_bwd_plan(b, tuple(shape[1:4]), cin, cout, pre, sms)
        nbytes, flops, peak = cs.op_work(d)
        bytes_ms, ops_ms = 1e3 * nbytes / cs.HBM_BYTES_PER_S, 1e3 * flops / peak
        ok = rec["ok"] and repeat
        failed += not ok
        line = {**d, "calls_per_step": n, "ok": ok, "repeat_bitwise": repeat,
                "tile": [plan["td"], plan["th"], plan["tw"]],
                "splits": plan["splits"], "co_chunks": plan["co_chunks"],
                "smem": plan["smem"], "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                **{k: v for k, v in rec.items() if k != "ok"}}
        lines.append(line)
        print(json.dumps(line), flush=True)
        for f in total:
            if f != "calls":
                total[f] += n * line[f]
        total["calls"] += n
        del x, gy, w, aff, a
        torch.cuda.empty_cache()
    summary = {"batch": args.batch, "per_step": total, "failed": failed,
               "card": card}
    lines.append(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    print(json.dumps(summary), flush=True)
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
