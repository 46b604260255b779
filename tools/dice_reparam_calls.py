#!/usr/bin/env python3
"""Time the Dice sums and the reparam + KL kernels of the port tree at
--root, forward and VJP, on one GPU, at the main path's shapes:

    python3 tools/dice_reparam_calls.py --root DIR [--seed 0] [--out PATH]

- ``dice_sums`` (kernels/csrc/losses.cu) at the adaptation step's call,
  [2, 128^3, 2] with K = 3 targets (the student's prediction against the
  VAE's reconstruction, a binarized pseudo-label and a one-hot label), and
  its VJP as the step's backward runs it: through autograd on a graph
  where the prediction and the reconstruction need gradients, whatever
  the tree's backward is (eager PyTorch or one kernel);
- ``reparam_kl`` (kernels/csrc/reparam.cu) at the vae_train step's call,
  [4, 128] at scale 0.35, and its VJP through autograd for the
  cotangents of the latent and the KL.

Each forward is timed as a replayed CUDA graph (device time only, with
the tree's own chip_smoke.py helper) and by CUDA events around repeated
calls, the reparam kernel also by profiler device time. A VJP is timed as
a graph two ways: the eager formula of the JAX package's VJP
(dicesums.py::_bwd, reparam.py::_reparam_bwd; what the tree's backward ran
before it had a kernel) and the tree's VJP wrapper where it has one
(``kernel_graph_ms``); and the autograd backward, as the step runs it, by
CUDA events (a capture of a forward and its autograd backward failed on
an H100 with torch 2.11). Host time a call: the host clock over calls without a
synchronisation (1000 for the reparam, 200 for the Dice sums, whose
device time is longer than their enqueue), the median of 5 rounds. Each autograd VJP is held to
the eager formula on the same inputs (``bitwise``: every bit agrees); the
Dice sums to their plain version within 2e-4 of the largest sum, the
reparam's latent and KL to theirs within 1e-6. The bounds: the bytes
each call must move (each input read once, each output written once) over
3.35 TB/s. To compare two trees on one card, run the tool on each in one
call (parent, change, change, parent). One JSON line a measurement, then
a summary line and the card's name and power limit. Exits 1 if a check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
DICE_SHAPE, DICE_K = (2, 128, 128, 128, 2), 3
REPARAM_SHAPE, REPARAM_SCALE = (4, 128), 0.35


def host_ms(torch, fn, n: int, rounds: int = 5) -> float:
    """Host-clock ms of one fn() call over n calls with no
    synchronisation between them, the median of `rounds` rounds."""
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    return sorted(times)[rounds // 2]


def dice_vjp_eager(g, pred, targets, need):
    """dicesums.py::_bwd in eager PyTorch, for dp and the targets whose
    flag in `need` (pred's first) is set: the gradients of `need`."""
    lead = (slice(None),) + (None,) * (pred.dim() - 2)
    dp = g[:, 0][lead].expand(pred.shape)
    out = []
    for i, t in enumerate(targets):
        dp = dp + g[:, 2 + 2 * i][lead] * t.float()
        if need[1 + i]:
            out.append((g[:, 1 + 2 * i][lead] + g[:, 2 + 2 * i][lead]
                        * pred.float()).to(t.dtype))
    return [dp.to(pred.dtype), *out]


def reparam_vjp_eager(mean, std, eps, g_latent, g_kl, scale):
    """reparam.py::_reparam_bwd in eager PyTorch: (d_mean, d_std)."""
    gk = g_kl / mean.shape[0]
    return (g_latent + gk * mean,
            g_latent * eps * scale + gk * (std - 1.0 / (std + 1e-5)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("dice_reparam_calls: no CUDA GPU is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vae_segmentation_tpu_torch.ops import losses, reparam

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    lines, failed = [], False

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    # ---- dice_sums and its VJP at the adaptation step's call
    shape, k = DICE_SHAPE, DICE_K
    b, c = shape[0], shape[-1]
    nbytes = 2 * torch.Size(shape).numel()          # one bf16 volume
    pred = torch.softmax(rnd(*shape), dim=-1).bfloat16()
    recon = torch.softmax(rnd(*shape), dim=-1).bfloat16()
    pseudo = (torch.softmax(rnd(*shape), dim=-1) >= 0.5).bfloat16()
    onehot = torch.nn.functional.one_hot(
        (rnd(*shape[:-1]) > 1.0).long(), c).bfloat16()
    targets = (recon, pseudo, onehot)
    with torch.no_grad():
        got = losses.dice_sums(pred, targets)
        want = losses.dice_sums_plain(pred, targets)
        err = ((got - want).abs().max() / want.abs().max()).item()
        rec = {"call": "dice_sums", "shape": list(shape), "targets": k,
               "rel_err": err, "ok": err <= 2e-4,
               "graph_ms": cs.graph_ms(torch, lambda: losses.dice_sums(
                   pred, targets)),
               "events_ms": cs.cuda_ms(torch, lambda: losses.dice_sums(
                   pred, targets)),
               "plain_graph_ms": cs.graph_ms(
                   torch, lambda: losses.dice_sums_plain(pred, targets)),
               "host_ms": host_ms(torch, lambda: losses.dice_sums(
                   pred, targets), 200),
               "bound_ms": 1e3 * ((1 + k) * nbytes + 4 * b * (1 + 2 * k) * c)
               / HBM_BYTES_PER_S}
    emit(rec)
    failed = failed or not rec["ok"]

    p_leaf = pred.clone().requires_grad_(True)
    r_leaf = recon.clone().requires_grad_(True)
    g = rnd(b, 1 + 2 * k, c)
    need = (True, True, False, False)

    sums = losses._DiceSumsFn.apply(p_leaf, r_leaf, pseudo, onehot)

    def dice_vjp():
        return torch.autograd.grad(sums, (p_leaf, r_leaf), g,
                                   retain_graph=True)

    got = dice_vjp()
    want = dice_vjp_eager(g, pred, targets, need)
    rec = {"call": "dice_sums VJP", "shape": list(shape), "targets": k,
           "need": list(need),
           "bitwise": all(bool(torch.equal(a, w)) for a, w in zip(got, want)),
           "eager_graph_ms": cs.graph_ms(
               torch, lambda: dice_vjp_eager(g, pred, targets, need)),
           "autograd_events_ms": cs.cuda_ms(torch, dice_vjp),
           "host_ms": host_ms(torch, dice_vjp, 200),
           # reads g, pred (for d recon) and the 3 targets (for dp);
           # writes dp and d recon
           "bound_ms": 1e3 * (6 * nbytes + 4 * b * (1 + 2 * k) * c)
           / HBM_BYTES_PER_S}
    if hasattr(losses, "dice_sums_vjp"):
        rec["kernel_graph_ms"] = cs.graph_ms(
            torch, lambda: losses.dice_sums_vjp(g, pred, targets, True,
                                                (True, False, False)))
    emit(rec)
    failed = failed or not rec["bitwise"]
    del sums, p_leaf, r_leaf, pred, recon, pseudo, onehot, targets, got, want
    torch.cuda.empty_cache()

    # ---- reparam_kl and its VJP at the vae_train step's call
    mean = rnd(*REPARAM_SHAPE) * 0.7
    std = rnd(*REPARAM_SHAPE).relu()
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    n = mean.numel()

    def fwd():
        return reparam.reparam_kl_op(mean, std, REPARAM_SCALE, seed)

    with torch.no_grad():
        latent, kl, eps = fwd()
        w_latent, w_kl = reparam.reparam_kl_plain(mean, std, REPARAM_SCALE,
                                                  eps)
        kl_rel = abs(kl.item() - w_kl.item()) / abs(w_kl.item())
        latent_rel = ((latent - w_latent).abs().max()
                      / w_latent.abs().max()).item()
        rec = {"call": "reparam_kl", "shape": list(REPARAM_SHAPE),
               "kl_rel_err": kl_rel, "latent_rel_err": latent_rel,
               "ok": kl_rel <= 1e-6 and latent_rel <= 1e-6,
               "profiler_ms": cs.profile_run(torch, fwd, 50, "",
                                             [])["device_ms"],
               "graph_ms": cs.graph_ms(torch, fwd),
               "events_ms": cs.cuda_ms(torch, fwd),
               "host_ms": host_ms(torch, fwd, 1000)}
    emit(rec)
    failed = failed or not rec["ok"]

    m_leaf = mean.clone().requires_grad_(True)
    s_leaf = std.clone().requires_grad_(True)
    g_latent = rnd(*REPARAM_SHAPE)
    g_kl = rnd(1).reshape(())

    latent, kl = reparam.reparam_kl(m_leaf, s_leaf, REPARAM_SCALE,
                                    seed)[:2]

    def reparam_vjp():
        return torch.autograd.grad((latent, kl), (m_leaf, s_leaf),
                                   (g_latent, g_kl), retain_graph=True)

    got = reparam_vjp()
    want = reparam_vjp_eager(mean, std, eps, g_latent, g_kl, REPARAM_SCALE)
    rec = {"call": "reparam_kl VJP", "shape": list(REPARAM_SHAPE),
           "bitwise": all(bool(torch.equal(a, w)) for a, w in zip(got, want)),
           "eager_graph_ms": cs.graph_ms(torch, lambda: reparam_vjp_eager(
               mean, std, eps, g_latent, g_kl, REPARAM_SCALE)),
           "autograd_events_ms": cs.cuda_ms(torch, reparam_vjp),
           "host_ms": host_ms(torch, reparam_vjp, 1000),
           # reads mean, std, eps, g_latent and g_kl; writes two gradients
           "bound_ms": 1e3 * (24 * n + 4) / HBM_BYTES_PER_S}
    if hasattr(reparam, "reparam_kl_vjp"):
        rec["kernel_graph_ms"] = cs.graph_ms(
            torch, lambda: reparam.reparam_kl_vjp(
                mean, std, eps, g_latent, g_kl, REPARAM_SCALE))
    emit(rec)
    failed = failed or not rec["bitwise"]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"root": root, "ok": not failed,
               "graph_ms": {r["call"]: r.get("kernel_graph_ms",
                                             r.get("graph_ms",
                                                   r.get("eager_graph_ms")))
                            for r in lines}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"calls": lines, **summary, "card": card}, f, indent=1)
    print(json.dumps(summary))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
