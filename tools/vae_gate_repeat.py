#!/usr/bin/env python3
"""Run chip_smoke.py's phase-9 gate (the vae_train step-1 gate, each loss
term where it is well conditioned) on one GPU, on chosen batches, for the
port tree at --root:

    python3 tools/vae_gate_repeat.py --root DIR [--runs 2] [--seed 0]
                                     [--draws 1-10] [--calls]
                                     [--fault conv3_dk|k1_bias|k1_stats]
                                     [--out PATH]

The tree's own chip_smoke.py supplies the constants, the plain path and the
gate's rules (``vae_terms``, ``vae_gate``, ``vae_backward_gate``,
``check_calls``); the model and the seeds are phase 9's (the ShapeVAE at
full width from --seed + 2, warped batches of 4 ground-truth masks at 128^3
from --seed + 3, reparam seed --seed). The batch is the k-th warp the
seeded generator draws, for each k of --draws ("1", "1-10" or "1,7,8"):
chip_smoke takes the 8th, the first after its timing of the warp (7
draws). For each batch the plain path, the reordered plain path and the
three stats-shuffled orders run once; the kernel path runs `--runs` times.
Each kernel run prints one JSON line with phase 9's verdict and its parts:
each loss term against its gate, the Dice term's worst gradient ratio, the
latent's distance from the plain path against its gate, the backward alone
(the full loss, the KL term's gradient with it, on one kernel-path
forward's graph), and, not gated, the KL term's end-to-end worst ratio.
Each batch's head line gives the encoder's std = relu(z) on the plain
path, the kernel path and the other four plain orders where any is in
(0, 1e-3): the KL's gradient in std is std - 1 / (std + 1e-5), so a z that
a rounding-level change moves across zero changes fc_std's gradient by up
to 1e5 a unit, which is why the KL term is held on one shared forward.
With --calls, each batch's plain step 1 is also recorded and every kernel
call held against its plain version by phase 8's checks
(chip_smoke.check_calls: the bf16 and f32 rules, K1's stats epilogue by
its two parts, the f64 gates of the weight gradients and norm sums, two
more launches for the same bits); one line per batch gives each kernel's
calls, failed calls and worst errors (for K1's stats epilogue: its
summation against the f64 sums of its own y, its y's elements beyond one
bf16 ulp, its flips off the once-rounded f64 conv (distinct values, and
elements) over their limit, and the stats' distance from the f64 stats,
reported). --fault plants a fault
in the kernel path (this tool's own wrappers; the package is untouched) to
show that the rules catch it: ``conv3_dk`` scales one conv3_dk call's dk
by 1.01; ``k1_bias`` drops one output channel's bias (its largest) from
one K1 forward call with the stats epilogue; ``k1_stats`` scales one
channel's sumsq (its largest) of such a call by 1 + 1e-4, a summation
fault the 1e-3 rule on the stats' distance from f64 let pass. Each faulted
call is the first in
launch order whose description (chip_smoke.describe) no other call of the
step shares. The last line is a summary: runs, failures and the worst
ratios per batch. Put two trees in one command to compare them on the same
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock


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


class FaultWrapper:
    """The kernel wrapper `real` (conv3.conv3_dk or conv3.conv3_op) with a
    planted fault on the calls whose chip_smoke.describe() is `target`:
    conv3_dk's dk times 1.01, K1's bias with its largest channel dropped,
    or K1's largest sumsq times 1 + 1e-4. It shows `real`'s signature (chip_smoke.plain_ops binds calls
    by it) and its launch counter (the wrapper counts itself by name)."""

    def __init__(self, cs, kind: str, target: str, real):
        import inspect

        self.cs, self.kind, self.target, self.real = cs, kind, target, real
        self.__signature__ = inspect.signature(real)

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, value):
        self.real.launches = value

    def __call__(self, *args, **kwargs):
        bound = self.__signature__.bind(*args, **kwargs)
        bound.apply_defaults()
        a = dict(bound.arguments)
        name = "conv3_dk" if self.kind == "conv3_dk" else "conv3"
        desc = self.cs.describe({"kernel": name, "args": a})
        if json.dumps(desc, sort_keys=True) != self.target:
            return self.real(**a)
        if self.kind == "conv3_dk":
            dk, db = self.real(**a)
            return dk * 1.01, db
        if self.kind == "k1_stats":
            y, st = self.real(**a)
            st = st.clone()
            c = int(st[0, 1].argmax())
            st[:, 1, c] *= 1 + 1e-4
            return y, st
        bias = a["bias"].clone()
        bias[bias.abs().argmax()] = 0.0
        return self.real(**{**a, "bias": bias})


def fault_target(cs, calls, kind: str) -> str:
    """The description of the first call of the faulted kernel (K1: a
    forward with the stats epilogue) that no other recorded call shares."""
    name = "conv3_dk" if kind == "conv3_dk" else "conv3"
    descs = [json.dumps(cs.describe(c), sort_keys=True) for c in calls]
    for c, d in zip(calls, descs):
        desc = cs.describe(c)
        if c["kernel"] == name and descs.count(d) == 1 and (
                kind == "conv3_dk" or (desc["role"] == "fwd"
                                       and desc["stats"])):
            return d
    raise RuntimeError(f"no call of {name} has a description of its own")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", default="8")
    ap.add_argument("--calls", action="store_true")
    ap.add_argument("--fault", choices=("conv3_dk", "k1_bias", "k1_stats"),
                    default=None)
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
    from vae_segmentation_tpu_torch.ops import conv3
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
    expected = cs.expected_source_step_launches(vae0, sampled=True)
    vfwd = cs.forward_launches(vae0)
    bwd_expected = {k: expected[k] - vfwd[k] for k in cs.KERNEL_NAMES}
    bwd_expected["reparam_kl"] = 0

    def fresh():
        """(ShapeVAE at step 1's weights, the reparam seed's generator)."""
        vae = ShapeVAE(n_class=2, dim=128, bottleneck=16384).cuda()
        vae.load_state_dict(state0)
        return vae, torch.Generator(device="cuda").manual_seed(args.seed)

    def step1(batch):
        """phase 8's vae_step1: the whole step at lr 0."""
        vae, g = fresh()
        opt = T.optim.sgd(vae.parameters(), 0.0)
        aux = step(vae, opt, batch, g)
        torch.cuda.synchronize()
        return aux

    def terms(batch, **plain):
        vae, g = fresh()
        if not plain:
            return cs.vae_terms(torch, vae, batch, g)
        with cs.plain_ops(**plain):
            return cs.vae_terms(torch, vae, batch, g)

    def check_calls(calls, draw):
        """Phase 8's per-call checks on the plain step 1's calls: one
        record per kernel."""
        fails = []
        got = cs.count_calls(calls)
        keys = cs.check_calls(torch, calls, fails, f"draw {draw}")
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
            if "y_flip_limit" in w:
                w = dict(w, y_flips_over_limit=w["y_flips"]
                         / w["y_flip_limit"])
            for f in ("stats_own_sum_err", "stats_own_sumsq_rel",
                      "y_beyond_ulp", "plain_y_beyond_ulp",
                      "y_flips_over_limit", "y_flips", "plain_y_flips",
                      "y_flip_elements", "plain_y_flip_elements",
                      "y_flip_share",
                      "plain_y_flip_share", "stats_sum_err",
                      "stats_sumsq_rel", "plain_stats_sum_err",
                      "plain_stats_sumsq_rel", "exact_rel_err"):
                if f in w:
                    v = max(w[f]) if isinstance(w[f], list) else w[f]
                    r[f] = max(r.get(f, 0.0), v)
            if not k["ok"]:
                r.setdefault("failed", []).append(
                    {**k["desc"], **{f: w[f] for f in w
                                     if f != "rel_err_by_output"}})
        ok = (got == expected and not fails
              and all(r["failed_calls"] == 0 for r in per.values()))
        return {"draw": draw, "launches": got,
                "launches_expected": expected, "kernels": per,
                "calls_ok": ok}

    real = {"conv3_dk": conv3.conv3_dk, "k1_bias": conv3.conv3_op,
            "k1_stats": conv3.conv3_op}
    attr = {"conv3_dk": "conv3_dk", "k1_bias": "conv3_op",
            "k1_stats": "conv3_op"}
    lines, per_draw = [], {}
    for draw in draws:
        batch = warps[draw]
        plain = terms(batch, reordered=False)
        other = terms(batch, reordered=True)
        shuffled = [terms(batch, reordered=True, stats_seed=seed)
                    for seed in (1, 2, 3)]
        calls = []
        if args.calls or args.fault:
            with cs.plain_ops(record=calls):
                step1(batch)
        target = cs_patch = None
        if args.fault:
            target = fault_target(cs, calls, args.fault)
            cs_patch = mock.patch.object(
                conv3, attr[args.fault],
                FaultWrapper(cs, args.fault, target, real[args.fault]))
            cs_patch.start()
        try:
            kern = terms(batch)
            std_k = kern["std"]
            head = {"root": root, "draw": draw, "fault": args.fault,
                    "fault_call": None if target is None
                    else json.loads(target),
                    "losses_plain": plain["losses"],
                    "std": small_std(plain["std"], std_k,
                                     [o["std"] for o in (other, *shuffled)])}
            lines.append(head)
            print(json.dumps(head), flush=True)
            calls_ok = None
            if args.calls:
                rec = check_calls(calls, draw)
                calls_ok = rec["calls_ok"]
                lines.append(rec)
                print(json.dumps(rec), flush=True)
            del calls
            torch.cuda.empty_cache()
            gates, failed = [], 0
            for run in range(args.runs):
                if run:
                    kern = terms(batch)
                gate = cs.vae_gate(torch, kern, plain, other, shuffled)
                vae, g = fresh()
                bwd = cs.vae_backward_gate(torch, ops, vae, batch, g,
                                           bwd_expected)
                del vae, kern
                ok = gate["ok"] and bwd["backward_ok"]
                failed += not ok
                rec = {"draw": draw, "run": run, "ok": ok,
                       "loss_rel_err": gate["loss_rel_err"],
                       "loss_gate": gate["loss_gate"],
                       "dice_worst_ratio": gate["dice_worst_ratio"],
                       "dice_worst_tensor": gate["dice_worst_tensor"],
                       "latent": gate["latent"],
                       "backward_worst_ratio": bwd["backward_worst_ratio"],
                       "backward_worst_tensor": bwd["backward_worst_tensor"],
                       "backward_ok": bwd["backward_ok"],
                       "kl_term_worst_ratio_not_gated":
                           gate["kl_term_worst_ratio_not_gated"],
                       "gate_ok": gate["ok"]}
                gates.append(rec)
                lines.append(rec)
                print(json.dumps(rec), flush=True)
        finally:
            if cs_patch is not None:
                cs_patch.stop()
        per_draw[draw] = {
            "failed": failed, "calls_ok": calls_ok,
            "dice_worst_ratio": max(r["dice_worst_ratio"] for r in gates),
            "backward_worst_ratio": max(r["backward_worst_ratio"]
                                        for r in gates),
            "latent_over_gate": max(
                v["kernel_vs_plain"] / v["gate"]
                for r in gates for v in r["latent"].values()),
            "loss_over_gate": max(r["loss_rel_err"][t] / r["loss_gate"][t]
                                  for r in gates for t in r["loss_gate"]),
            "kl_term_worst_ratio_not_gated": max(
                r["kl_term_worst_ratio_not_gated"] for r in gates)}
        del plain, other, shuffled
        torch.cuda.empty_cache()
    summary = {"root": root, "runs": args.runs, "draws": draws,
               "fault": args.fault,
               "failed": sum(v["failed"] for v in per_draw.values()),
               "calls_failed": sum(v["calls_ok"] is False
                                   for v in per_draw.values()),
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
