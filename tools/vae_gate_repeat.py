#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase-9 gate (the vae_train step-1 loss and
gradient gate) many times on one GPU, on one batch, for the port tree at
--root:

    python3 tools/vae_gate_repeat.py --root DIR [--runs 15] [--seed 0]
                                     [--draws 1] [--calls] [--out PATH]

The tree's own chip_smoke.py supplies the constants, the plain path and the
gate's arithmetic; the model and the seeds are phase 9's (the ShapeVAE at
full width from --seed + 2, warped batches of 4 ground-truth masks at 128^3
from --seed + 3, reparam seed --seed). The batch is the k-th warp the
seeded generator draws, for each k of --draws ("1", "1-12" or "1,7,8"):
phase 9 takes the 8th, the first after phase 10's timing of the warp (7
draws). For each batch the
plain path, the reordered plain path and the three stats-shuffled orders
run once; the kernel path runs `--runs` times, each a fresh vae_train
step 1.
Each kernel run prints one JSON line: the worst gradient ratio against
DRIFT_MULTIPLE, its tensor, each loss term's relative error and gate, and
whether phase 9's step gate holds (the backward-alone half of phase 9 is
not repeated), and the worst ratio again against the largest drift over
all four plain-path orders (the stats-shuffled ones too), where the
gate takes the conv-split order alone. Each batch's head line gives the
encoder's std = relu(z) on the plain path, the kernel path and the other
three plain orders where any is in (0, 1e-3), and how far each path's std
lies from the plain path's on average: the KL's gradient in std is std - 1 / (std + 1e-5), so a z
that a rounding-level change moves across zero changes fc_std's gradient
by up to 1e5 a unit. With --calls, each batch's plain step 1 is also
recorded and every kernel call held against its plain version by phase
8's checks (chip_smoke.check_calls: the bf16 and f32 rules, K1's stats
gate, the f64 gates of the weight gradients and norm sums, two more
launches for the same bits); one line per batch gives each kernel's
calls, failed calls and worst errors, and how far K1's and the plain
version's stats lie from their f64 value. The last line is a summary:
runs, failures and ratios per batch. Put two trees in one command to
compare their failure rates on the same card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def small_std(std_p, std_k, std_orders):
    """Where any path's std is in (0, 1e-3): the plain path's, the kernel
    path's and each other plain order's values (a zero is a z on the other
    side of the ReLU), beside the count of zeros, the plain path's median
    std where it is not zero, and each path's mean |std - plain std| (how
    far its forward moved the latent)."""
    paths = [std_p, std_k, *std_orders]
    near = sum(((s > 0) & (s < 1e-3)).int() for s in paths) > 0
    return {"zero_plain": int((std_p == 0).sum()),
            "zero_kernels": int((std_k == 0).sum()),
            "median_plain": std_p[std_p > 0].median().item(),
            "mean_abs_diff_kernels": (std_k - std_p).abs().mean().item(),
            "mean_abs_diff_orders": [(s - std_p).abs().mean().item()
                                     for s in std_orders],
            "near_zero": [{"plain": v[0], "kernels": v[1], "orders": v[2:]}
                          for v in torch_rows(paths, near)]}


def torch_rows(paths, mask) -> list:
    """[[path 0's value, path 1's, ...] at each masked entry]."""
    import torch

    return torch.stack([s[mask] for s in paths], dim=1).tolist()


def k1_stats_f64(calls, conv3_op):
    """K1's calls with the stats epilogue: how far K1's stats and the
    plain version's lie from the f64 stats (the f64 conv of the f32 xn and
    the bf16 weight, plus bias, rounded to bf16 once, summed in f64), under
    chip_smoke's measures (sum error over sum |y|, sumsq relative); the
    largest over the calls, and each call whose K1 stats miss the 1e-3
    gate against the plain version."""
    import torch
    import torch.nn.functional as F

    from vae_segmentation_tpu_torch.ops import conv3

    def measure(st, want, abs_sum):
        st, want = st.double(), want.double()
        return [((st[:, 0] - want[:, 0]).abs() / abs_sum).max().item(),
                ((st[:, 1] - want[:, 1]).abs()
                 / want[:, 1].clamp_min(1e-30)).max().item()]

    out = {"k1": [0.0, 0.0], "plain": [0.0, 0.0], "missed": []}
    with torch.no_grad():
        for c in calls:
            a = c["args"]
            if c["kernel"] != "conv3" or not a["stats"]:
                continue
            st = conv3_op(**a)[1]
            yp, sp = c["out"]
            pre = a["pre"]
            x, bias = a["x"], a["bias"]
            xn = x.float() if pre is None else conv3._affine_relu(x, pre)
            ref = F.conv3d(
                xn.double().permute(0, 4, 1, 2, 3),
                a["weight"].to(torch.bfloat16).double(),
                None if bias is None else bias.double(), padding=1)
            del xn
            ref = ref.permute(0, 2, 3, 4, 1).to(torch.bfloat16).double()
            exact = torch.stack([ref.sum(dim=(1, 2, 3)),
                                 (ref * ref).sum(dim=(1, 2, 3))], dim=1)
            del ref
            abs_sum = yp.double().abs().sum(dim=(1, 2, 3))
            ek = measure(st, exact, abs_sum)
            ep = measure(sp, exact, abs_sum)
            out["k1"] = [max(u, v) for u, v in zip(out["k1"], ek)]
            out["plain"] = [max(u, v) for u, v in zip(out["plain"], ep)]
            kp = measure(st, sp, abs_sum)
            if max(kp) > 1e-3:
                out["missed"].append({
                    "shape": list(x.shape), "cout": sp.shape[-1],
                    "pre": pre is not None, "k1_vs_plain": kp,
                    "k1_vs_f64": ek, "plain_vs_f64": ep})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", default="1")
    ap.add_argument("--calls", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("vae_gate_repeat: no CUDA GPU is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from vae_segmentation_tpu_torch import ops
    from vae_segmentation_tpu_torch import train as T
    from vae_segmentation_tpu_torch.data import augment
    from vae_segmentation_tpu_torch.data.pipeline import CaseDataset
    from vae_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)
    from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
    from vae_segmentation_tpu_torch.models import ShapeVAE
    from vae_segmentation_tpu_torch.ops import losses as L
    from vae_segmentation_tpu_torch.ops.kernels import build

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    work = os.path.join(root, ".smoke_work", "vae_gate")
    with open(write_synthetic_dataset(
            os.path.join(work, "data_source"), n_train=cs.VAE_BATCH,
            n_val=0, size=128, seed=args.seed + 3)) as f:
        entries = json.load(f)["NIH_train"]
    ds = CaseDataset(entries, os.path.join(work, "data_source"),
                     parse_pan_index("1"))
    cases = [ds[i] for i in range(cs.VAE_BATCH)]
    img = torch.stack([torch.from_numpy(c["image"]) for c in cases]).cuda()
    lab = torch.stack([torch.from_numpy(c["label"]) for c in cases]).cuda()
    draws = sorted({k for part in args.draws.split(",")
                    for k in (range(int(part.split("-")[0]),
                                    int(part.split("-")[-1]) + 1))})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    warps = {}
    for k in range(1, draws[-1] + 1):
        lab_k = augment.spatial_augment(img, lab, gen,
                                        patch_size=(128, 128, 128))[1]
        if k in draws:
            warps[k] = lab_k
    vae0 = ShapeVAE(n_class=2, dim=128, bottleneck=16384,
                    generator=torch.Generator().manual_seed(args.seed + 2))
    state0 = {k: v.detach().cuda() for k, v in vae0.state_dict().items()}
    step = T.make_vae_train_step(2, scale=cs.VAE_SCALE)
    conv3_op = {n: getattr(m, a) for n, m, a, _ in cs.kernel_ops()}["conv3"]
    expected = cs.expected_source_step_launches(vae0, sampled=True)

    def encoder_std(batch):
        """The encoder's std on `batch` (std = relu(z))."""
        vae = ShapeVAE(n_class=2, dim=128, bottleneck=16384).cuda()
        vae.load_state_dict(state0)
        with torch.no_grad():
            return vae.encode(L.one_hot_label(batch, 2))[1]

    def check_calls(batch, draw):
        """Phase 8's per-call checks on the plain step 1's calls: one
        record per kernel."""
        calls, fails = [], []
        with cs.plain_ops(record=calls):
            step1(batch)
        got = cs.count_calls(calls)
        keys = cs.check_calls(torch, calls, fails, f"draw {draw}")
        stats_f64 = k1_stats_f64(calls, conv3_op)
        per = {}
        for k in keys.values():
            name = k["desc"]["kernel"] + (
                "" if k["desc"].get("role", "fwd") == "fwd" else "/dx")
            w = k["worst"]
            r = per.setdefault(name, {"calls": 0, "failed_calls": 0,
                                      "not_repeated": 0, "worst_rel": 0.0})
            r["calls"] += k["count"]
            r["failed_calls"] += 0 if k["ok"] else k["count"]
            r["not_repeated"] += k["repeat"] is False
            r["worst_rel"] = max(r["worst_rel"], cs._worst_rel(w))
            for f in ("stats_sum_err", "stats_sumsq_rel", "exact_rel_err"):
                if f in w:
                    v = max(w[f]) if isinstance(w[f], list) else w[f]
                    r[f] = max(r.get(f, 0.0), v)
            if not k["ok"]:
                r.setdefault("failed", []).append(
                    {**k["desc"], **{f: w[f] for f in w
                                     if f != "rel_err_by_output"}})
        ok = (got == expected and not fails
              and all(r["failed_calls"] == 0 for r in per.values()))
        del calls, keys
        torch.cuda.empty_cache()
        return {"draw": draw, "launches": got,
                "launches_expected": expected, "kernels": per,
                "k1_stats_f64": stats_f64, "calls_ok": ok}

    def step1(batch):
        """phase 9's vae_step1: loss terms and gradients at lr 0."""
        vae = ShapeVAE(n_class=2, dim=128, bottleneck=16384).cuda()
        vae.load_state_dict(state0)
        opt = T.optim.sgd(vae.parameters(), 0.0)
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        aux = step(vae, opt, batch, g)
        grads = {k: p.grad.detach().clone()
                 for k, p in vae.named_parameters()}
        torch.cuda.synchronize()
        return {k: v.item() for k, v in aux.items()}, grads

    lines, per_draw = [], {}
    for draw in draws:
        batch = warps[draw]
        with cs.plain_ops():
            aux_p, grads_p = step1(batch)
        with cs.plain_ops(reordered=True):
            aux_r, grads_r = step1(batch)
        with cs.plain_ops(reordered=True):
            std_o = [encoder_std(batch)]
        aux_s, drift_s = [], []
        for seed in (1, 2, 3):
            with cs.plain_ops(reordered=True, stats_seed=seed):
                aux_k, grads_k = step1(batch)
                std_o.append(encoder_std(batch))
            aux_s.append(aux_k)
            drift_s.append(cs.grad_drift(grads_k, grads_p))
            del grads_k
        orders = [{k: abs(a[k] - aux_p[k]) / abs(aux_p[k]) for k in aux_p}
                  for a in (aux_r, *aux_s)]
        gate = {k: max(cs.DRIFT_MULTIPLE * max(o[k] for o in orders), 1e-3)
                for k in aux_p}
        drift_all = {k: max(v, *(d[k] for d in drift_s))
                     for k, v in cs.grad_drift(grads_r, grads_p).items()}
        median_all = sorted(drift_all.values())[len(drift_all) // 2]
        with cs.plain_ops():
            std_p = encoder_std(batch)
        head = {"root": root, "draw": draw, "losses_plain": aux_p,
                "loss_gate": gate,
                "std": small_std(std_p, encoder_std(batch), std_o)}
        del std_p, std_o
        lines.append(head)
        print(json.dumps(head), flush=True)
        calls_ok = True
        if args.calls:
            rec = check_calls(batch, draw)
            calls_ok = rec["calls_ok"]
            lines.append(rec)
            print(json.dumps(rec), flush=True)
        ratios, failed = [], 0
        for run in range(args.runs):
            ops.reset_launch_counts()
            aux_k, grads_k = step1(batch)
            err = {k: abs(aux_k[k] - aux_p[k]) / abs(aux_p[k])
                   for k in aux_p}
            err_k, _, worst = cs.drift_ratios(grads_k, grads_p, grads_r)
            top = sorted(worst, key=worst.get, reverse=True)[:3]
            all_orders = {k: v / max(drift_all[k], median_all)
                          for k, v in err_k.items()}
            top_all = max(all_orders, key=all_orders.get)
            ok = (all(err[k] <= gate[k] for k in err)
                  and all(v <= cs.DRIFT_MULTIPLE for v in worst.values())
                  and all(bool(torch.isfinite(g).all())
                          for g in grads_k.values()))
            failed += not ok
            ratios.append(worst[top[0]])
            rec = {"draw": draw, "run": run, "worst_ratio": worst[top[0]],
                   "worst": {k: worst[k] for k in top},
                   "worst_ratio_all_orders": {top_all: all_orders[top_all]},
                   "losses": aux_k,
                   "loss_rel_err": err, "launches": ops.launch_counts(),
                   "ok": ok}
            lines.append(rec)
            print(json.dumps(rec), flush=True)
            del grads_k
        per_draw[draw] = {"failed": failed, "worst_ratios": sorted(ratios),
                          "calls_ok": calls_ok if args.calls else None}
        del grads_p, grads_r
    summary = {"root": root, "runs": args.runs, "draws": draws,
               "failed": sum(v["failed"] for v in per_draw.values()),
               "drift_multiple": cs.DRIFT_MULTIPLE, "per_draw": per_draw}
    lines.append(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
