#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase-9 gate (the vae_train step-1 loss and
gradient gate) many times on one GPU, on one batch, for the port tree at
--root:

    python3 tools/vae_gate_repeat.py --root DIR [--runs 15] [--seed 0]
                                     [--out PATH]

The tree's own chip_smoke.py supplies the constants, the plain path and the
gate's arithmetic; the model, the seed and the batch are phase 9's (the
ShapeVAE at full width from --seed + 2, the first warped batch of 4
ground-truth masks at 128^3 from --seed + 3, reparam seed --seed). The plain
path, the reordered plain path and the three stats-shuffled orders run
once; the kernel path runs `--runs` times, each a fresh vae_train step 1.
Each kernel run prints one JSON line: the worst gradient ratio against
DRIFT_MULTIPLE, its tensor, each loss term's relative error and gate, and
whether phase 9's step gate holds (the backward-alone half of phase 9 is
not repeated). The last line is a summary: runs, failures, ratios. Put two
trees in one command to compare their failure rates on the same card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
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
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    batch = augment.spatial_augment(img, lab, gen,
                                    patch_size=(128, 128, 128))[1]
    vae0 = ShapeVAE(n_class=2, dim=128, bottleneck=16384,
                    generator=torch.Generator().manual_seed(args.seed + 2))
    state0 = {k: v.detach().cuda() for k, v in vae0.state_dict().items()}
    step = T.make_vae_train_step(2, scale=cs.VAE_SCALE)

    def step1():
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

    with cs.plain_ops():
        aux_p, grads_p = step1()
    with cs.plain_ops(reordered=True):
        aux_r, grads_r = step1()
    aux_s = []
    for seed in (1, 2, 3):
        with cs.plain_ops(reordered=True, stats_seed=seed):
            aux_s.append(step1()[0])
    orders = [{k: abs(a[k] - aux_p[k]) / abs(aux_p[k]) for k in aux_p}
              for a in (aux_r, *aux_s)]
    gate = {k: max(cs.DRIFT_MULTIPLE * max(o[k] for o in orders), 1e-3)
            for k in aux_p}
    lines = [{"root": root, "losses_plain": aux_p, "loss_gate": gate}]
    print(json.dumps(lines[0]), flush=True)
    ratios, failed = [], 0
    for run in range(args.runs):
        ops.reset_launch_counts()
        aux_k, grads_k = step1()
        err = {k: abs(aux_k[k] - aux_p[k]) / abs(aux_p[k]) for k in aux_p}
        _, _, worst = cs.drift_ratios(grads_k, grads_p, grads_r)
        top = sorted(worst, key=worst.get, reverse=True)[:3]
        ok = (all(err[k] <= gate[k] for k in err)
              and all(v <= cs.DRIFT_MULTIPLE for v in worst.values())
              and all(bool(torch.isfinite(g).all())
                      for g in grads_k.values()))
        failed += not ok
        ratios.append(worst[top[0]])
        rec = {"run": run, "worst_ratio": worst[top[0]],
               "worst": {k: worst[k] for k in top}, "losses": aux_k,
               "loss_rel_err": err, "launches": ops.launch_counts(),
               "ok": ok}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del grads_k
    summary = {"root": root, "runs": args.runs, "failed": failed,
               "drift_multiple": cs.DRIFT_MULTIPLE,
               "worst_ratios": sorted(ratios)}
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
