#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vae_segmentation_tpu_torch) on one NVIDIA
GPU and check it. Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--cases 3] [--out PATH]

Phases, each printed as JSON records:
  1. card: ``nvidia-smi`` name and power limit; the kernels' nvcc build
     (one nvcc per source, all at once); the tensor-core instructions
     (HMMA, HGMMA) in each built library's SASS (``cuobjdump -sass``):
     conv3's, conv3_dk's, conv3_bwd's, the bridges' and the bridge
     backwards' must have them, and so must the functions of K2's and K3's
     dx kernels (``TENSOR_CORE_KERNELS``: bridge_bwd's HMMA could come from
     its other kernels alone); the functions of the 16-byte kernels
     (``VECTOR_KERNELS``: norm_elementwise_kernel, softmax_vjp_c2_kernel,
     dice_sums_vec_kernel, dice_vjp_vec_kernel) must hold 128-bit global
     loads (LDG.*.128) and, but for the Dice sums' reduction, stores
     (STG.*.128); a toolkit without cuobjdump fails the check.
     Then the device kernels of one norm, forward (instance_norm_act) and
     backward (norm_bwd), at each norm shape of the norm route's eval
     forward (``NORM_SHAPES``), by the profiler: 2-3 each way
     (``kernels_per_norm``).
  2. kernels: one Joint forward of the eval path runs through the plain
     PyTorch versions (f32 math, TF32 off) with hooks recording every
     kernel-backed call (58 + 9 + 9). Each call's kernel then runs on that
     call's recorded inputs against its recorded plain output: y max abs
     err <= 1e-2 * max|y| (softmax probabilities <= 1e-2 abs), K1's stats
     epilogue by its two parts (``_compare``): its summation against the
     f64 sums of its own stored y (sum err over sum|y| and sumsq rel err
     each <= K1_SUM_TOL), its stored y against the f64 conv of the call's
     inputs rounded to bf16 once (each element within one bf16 ulp beyond
     the f32 sum's own error, and at most twice the plain version's count
     of distinct values off the once-rounded value), and two more launches
     of every K1, K2 and K3 call must give the same bits (y and stats). Each
     distinct (kernel, shape, options) is timed beside the plain version and
     one cuDNN call (bf16, channels_last_3d; a yardstick only, the port
     never calls it); K1, K2, K3 and their cuDNN calls also as a replayed
     CUDA graph (device time only: the deep stages' calls are shorter than
     their enqueue), and a call whose plan splits K also under the one-pass
     plan.
     ``bound_ms`` is the larger of the bytes over 3.35 TB/s and the
     operations over 989 TFLOP/s (bf16; 67 TFLOP/s for the two f32
     elementwise kernels).
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
     (``torch.profiler``) and the device's busy share of the forward; a
     kernel of the port's sources that no family names fails the run.
  5. train-step kernels: one adaptation train step (batch 2, 128^3, MC
     dropout 0.5, VAE frozen) runs on the plain path while every kernel
     wrapper's call is recorded, forward and backward (conv3 as forward
     and as dx conv with its ``post`` epilogue, conv3_dk, both bridges and
     their backwards, softmax_vjp, dice_sums and its VJP dice_sums_vjp).
     Each call's kernel then runs
     on the recorded inputs against the recorded plain outputs: bf16
     outputs within 1e-2 * max|want|, f32 sums (dk, db, ds/dt, Dice sums)
     within ``F32_TOL`` of their tensor's largest element; conv3_dk's dk
     and db, sums that cancel under an InstanceNorm, against their f64 value
     instead: within ``F32_TOL`` of its largest element or no further from
     it than twice the plain version is. Each distinct
     call is timed beside its plain version and one library call
     (``aten.convolution_backward`` with the matching output mask for the
     backward rows, ``aten._softmax_backward_data`` for softmax_vjp; none
     for dice_sums and its VJP; softmax_vjp and its library call, and
     dice_sums and its plain version, also as a replayed CUDA graph;
     dice_sums_vjp and its eager plain version only so). softmax_vjp and
     dice_sums_vjp must equal their plain versions bit for bit (they round
     as the plain versions do). Two more launches of every
     recorded call of K1 (y, the stats or the post epilogue's dx and (ds,
     dt)), conv3_dk, the bridge backwards (dx, dk, db and K2's (ds, dt)),
     dice_sums, its VJP, softmax_vjp and the norm kernels must give the
     same bits
     (none of them adds with atomics); a bridge
     backward that computes dx and dk is also timed for each part alone,
     K2's dx alone also as a replayed CUDA graph beside the dx-only
     library call (``aten.convolution_backward``, mask (T, F, F)) by both
     clocks (``down_dx_variants``), and a K1 call whose plan splits K under
     the one-pass plan too.
     ``bound_ms`` as in phase 2, but a weight gradient under a prologue
     counts its products against 495 TFLOP/s (TF32: its operand xn is
     f32).
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
     deterministic per seed; timed beside the plain version and an empty
     kernel (the launch floor), with the wrapper's host time a call.
  8. vae_train kernels: one source-recipe vae_train step (batch 4 of warped
     ground-truth masks, the seeded generator's 8th warp whatever the host's
     clock, 128^3, reparam scale 0.35, nothing frozen) runs on
     the plain path while every kernel call is recorded; each call's kernel
     then runs on the recorded inputs under phase 5's rules (reparam_kl_vjp
     bit for bit, timed by graph beside its eager plain version) and each
     distinct call is timed beside its plain version and library call.
  9. the vae_train step-1 gate, kernel path against plain path (same
     weights, batch and reparam seed), each loss term where it is well
     conditioned (``vae_gate``, ``vae_backward_gate``): each loss term and
     the latent (mean |mean - plain mean|, mean |std - plain std|) within
     ``DRIFT_MULTIPLE`` times the plain path's own largest drift over four
     summation orders (the conv sums split by channels, alone and with K1's
     norm statistics also summed in three shuffled orders); the Dice term's
     gradient end to end within ``DRIFT_MULTIPLE`` times the plain path's
     drift under reordered f32 sums; the full loss's gradient (the KL
     term's with it) on one kernel-path forward's graph, kernel backward
     against plain backward, likewise. A second kernel-path step 1 must
     repeat the first's losses and gradients bit for bit.
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
     against their f64 value; norm_apply's y, s and t and norm_bwd_dx bit
     for bit, on the recorded sums and again on their reduction kernel's
     own f64 sums: ``on_kernel_sums``), launches 58 / 9 / 9 / 56 / 56 per
     forward, its norms of the shapes phase 1 counted; phases 3-4
     (the eval CLI, the forward's divergence gate, ``forward_ms``, a
     profile); one adaptation step recorded and every call held likewise
     (norm_bwd_sums and norm_bwd_dx among them; each
     norm_stats and norm_bwd_sums call records its plan, one launch or two
     passes, and where one launch can take it both plans' device time as a
     replayed CUDA graph, ``norm_plans``); phase
     6's pseudo-label gradient gate and 3 steps; phase 10's 3 vae_train
     steps; each beside the default route's numbers.
 13. the merged backward (VAESEG_MERGED_BWD=1): conv3_bwd on the inputs of
     each conv backward recorded in phase 8, each dx conv paired with the
     conv3_dk call of the same conv, held against the pair's plain outputs
     (dx bf16 rule, (ds, dt) F32_TOL, dk and db against their f64 value),
     two more launches giving the same bits, and timed by CUDA events and
     as a replayed CUDA graph beside the pair's kernels and
     ``aten.convolution_backward`` with mask (T, T, T), and by events
     beside its plain version (this check runs right after phase 8's, while
     the recording is alive); then step 1 on the merged route twice (31
     conv3_bwd, 1 conv3_dk, no dx conv; the same bits in the losses and
     every gradient), its backward against the plain backward on one
     shared forward (phase 9's ``vae_backward_gate``), and phase 10's 3
     vae_train steps on the merged route (the same launches a step).
 14. test time, on the default route (``test_time``): (a) the target CLI
     ``--test_only --val_finetune 1`` on phase 3's cases and checkpoint
     (ft1: one finetune step and two Joint forwards a case, derived from
     the model; score_0 and score_noft_0 with a Dice in [0, 1] a case, and
     score_noft_0 equal to phase 3's score_0 value for value: every call
     repeats bit for bit, so a difference is the finetune copy leaking into
     the student); (b) one ft1 step at batch 1 on case 0 through the CLI's
     finetune (``target_main._make_finetune``): every kernel call held
     against its plain version under phase 5's rules, untimed
     (``check_untimed``), launches derived from the model, the loss terms,
     the Seg update and the finetune copy's VAE by ``gate_step``'s rule,
     the student's weights and requires_grad flags bit for bit as before, and the host-clock time ft1 adds to a case; (c) two
     synthetic 160^3 cases (padded to 192^3: 8 windows of 128^3 at overlap
     0.5, 2 chunks at batch 4) through the target CLI ``--eval_mode
     sliding_window -b 4``: plain, with ``--postprocess
     --postprocess_min_voxels 100`` and composed with ``--val_finetune 1``
     (each Dice in [0, 1], launches = chunks x the SegUNet forward's plus
     the finetune steps, score_noft_0 of the composed run equal to the
     plain sweep's score_0); every kernel call of one batch-4 window chunk
     held against its plain version (untimed); case 0's stitched
     probabilities on the kernel path against the plain path (mean abs
     difference within ``DRIFT_MULTIPLE`` times the plain path's reordered
     drift, Dice within 0.01); the sweep's seconds, windows and ms a chunk.
 15. the runs that outlive one process and the last training flags, on
     the default route (``later_flags``): (a) ``--resume``: the vae_train
     CLI (batch 4, the warp on) and the target CLI (batch 2, from phase
     11's checkpoints) each train two outer epochs, then a third resumed
     from the second's ``model_epoch2.ckpt``: the resume line, the loss
     lines of outer epoch 3 only, the best result carried, the restored
     weights equal to the file's bit for bit on the card, launches derived
     from the models, each checkpoint's size and save / load seconds;
     (b) the source replay: every kernel call of one replay step
     (``make_seg_replay_step``, batch 2) against its plain version,
     untimed and repeated bit for bit (``check_untimed``), its loss, Seg
     update and unmoved VAE by ``gate_step``'s rule; ``step_ms``,
     ``enqueue_ms``,
     device ms and busy share of the replay step and of one adaptation
     ('pseudo' variant) + replay iteration; the target CLI with
     ``--pseudo_list`` (two outer epochs, one replay step after each
     adaptation step, four loss terms a line); (c) the cubic warp
     (``--aug_order 3``) of one draw at [4, 128^3] in f32 on the card
     against the same sampling grid warped in f64 on the CPU (within
     ``CUBIC_F32_TOL`` of the largest |value|, the mask and the label
     equal), ``warp_ms`` at order 3 and order 1; (d) a seg_train CLI
     with ``--aug_host`` (launches derived from the model) and the host
     loader's ms a batch at order 1 and 3.
 16. the host data layer (``host_data``, default route): the native
     loader's build from ``data/csrc/fastloader.cpp`` into a scratch
     directory, timed (a failed build raises), with the CPU model,
     ``os.cpu_count()`` and ``VAESEG_LOADER_THREADS``; for each of phase
     3's 128^3 phantoms and two 256^3 phantoms whose ROI crop is 180 and
     210 a side, the numpy path against the native one, three times in
     turns: ms of load + remap, bbox (fused into the native load) and crop
     + resize to 128^3 (median), the native image, label and bbox equal to
     numpy's, the native resize within rtol 2e-4 / atol 2e-3 of scipy's
     (order 1) with under 1e-3 of the label's voxels differing (order 0);
     then phase 3's eval CLI on the numpy path and the native path in turns
     (numpy, native, native, numpy): ``cli_s`` a case beside phase 3's, the
     native runs repeating phase 3's scores and launches.
 17. the mesh (``parallel/``, ROADMAP item 9), on ranks that share the
     one card over gloo (NCCL takes one rank a card), so no number here
     measures scaling: (a) right after phase 5's check, while its recording
     is alive, K1 (prologue + stats, and the dx conv with ``post``),
     ``conv3_dk`` under the prologue and ``conv3_bwd`` with a valid-plane
     range (``dlim``), on the SP2 slabs [B, D/2 + 2, H, W, C] of the
     step's first call of each at D 128-4, the first slab's range, the
     last's and an interior one's (``dlim_calls``): each against its plain
     version under phase 5's rules (K1's stats and the weight gradients'
     references masked by the range too), timed and bounded; then
     (``stitch_check``) the two edge slabs put together as two ranks would
     against the kernel's whole call: y's owned planes bit for bit where
     the split counts agree, the stats less the halo planes' sums against
     the f64 sums of the owned planes within K1_SUM_TOL, dx with the halo
     gradients added back (bf16 rule; the planes no halo touches bit for
     bit likewise, and always for the merged backward), (ds, dt), dk, db
     within F32_TOL; (b) phase 6's step
     1 (full width, 128^3, batch 2, dropout 0.5, the same weights, batch
     and generator) on worlds of 2 (DP2, SP2) and 4 ranks (DP2 x SP2)
     (``adapt_world``, ``world_gate``): the loss terms within phase 6's
     loss gate of the one-process kernel step's, each gradient tensor of
     the full loss and of the pseudo-label loss alone within
     DRIFT_MULTIPLE times the plain path's reordered drift, every rank's
     gradients and updated parameters the same bits, the VAE unmoved, K1
     and conv3_dk launched with a range on every rank of a 'spatial' mesh,
     one step on each opt-in route (VAESEG_MERGED_BWD=1: conv3_bwd with a
     range; VAESEG_PALLAS=1: each norm's sums over the data row) finite,
     with its kernels launched and the same gradient bits on every rank,
     and per rank step_ms, peak memory, the backend and those launches; (c) ``source_main --method
     vae_train`` (DP2, no flag) and ``target_main --spatial_shards 2`` (a
     1 x 2 mesh) under ``torchrun --standalone --nproc_per_node 2`` on
     phase 5's training cases and phase 3's phantoms, one training epoch
     each, scores within phase 3's Dice gate (0.01) of the same run in one
     process, then ``--test_only`` on the target run's checkpoint under
     torchrun (its scores the run's last). Each world has a deadline
     (``WORLD_TIMEOUT``): a rank that dies or hangs fails the phase.
 18. the serving outputs and observability (ROADMAP item 11b) and the
     Joint's source methods (item 11c), on the default route
     (``serving_and_methods``): (a) the eval CLI ``--test_only`` on phase
     3's phantoms plain and with ``--save_eval_result
     --save_more_reference`` (and ``--analysis_figure_name`` where
     matplotlib imports) in turns (plain, outputs, outputs, plain): every
     run's scores equal, launches derived from the model (the analysis adds
     two Joint forwards and a VAE forward a case), the dumped prediction,
     image and one-hot label equal to phase 3's model's on the card bit
     for bit, the four figures, the analysis metrics of each case finite
     and in [0, 1], ``cli_s`` of each run and the bytes written; a
     ``--profile_dir`` run whose Chrome trace holds one primary kernel a
     K1, K2 and K3 launch (``trace_kernels``); whether tensorboardX and
     matplotlib import on the card's image; (b) one step of joint_train,
     the cached pseudo label's domain_adaptation and sep_joint_train at
     batch 2 from phase 3's weights (the VAE frozen; the teacher Joint a
     copy): every kernel call against its plain version (untimed,
     ``check_untimed``), launches derived from the model
     (``expected_joint_step_launches``), the loss terms, the Seg update
     and the unmoved VAE by ``gate_step``'s rule;
     ``step_ms``, ``enqueue_ms``, peak memory and launches of 3 steps;
     (c) ``source_main`` with each method from phase 3's checkpoint on
     phase 5's train cases (the warp on): joint_train and sep_joint_train
     one outer epoch, domain_adaptation two with ``--mode 1`` (epoch 0
     fills the pseudo cache, epoch 1 trains and refreshes it): launches,
     loss lines, scores in [0, 1], the cache's files.
 19. the Joint's last models and methods (ROADMAP items 11d, 11e, 11f,
     11h; ``remaining_methods``): (a) a soft-ReLU vae_train step at batch
     4 on the default route and on the norm route; (b) a
     discriminator_train step at batch 4 and a domain_adaptation_dis step
     at batch 2 (the Dis frozen, a teacher SegUNet); (c) an embed_train
     step (enc_on 1, the VAE frozen) and a refine_vae step (the VAE's
     encoder half frozen) at batch 2; each from seeded full-width weights
     on phase 5's train cases: every kernel call against its plain version
     (untimed), launches derived from the model, and ``gate_step``'s rule:
     each loss term within ``DRIFT_MULTIPLE`` times its largest drift over
     the plain path's other orders (phase 9's four for the default route's
     steps with a reparam KL), every trained tensor's update by phase 6's rule and
     moved, the frozen weights unmoved; ``step_ms``, ``enqueue_ms``, peak
     memory of 3 steps and the profiler's device time of 2; (d) the
     target CLI's vae_train --softrelu 1, discriminator_train and
     domain_adaptation_dis, the source CLI's embed_train (crop and
     sliding-window eval) and refine_vae, at 128^3 on phase 5's train
     cases and phase 3's phantoms: launches derived from the model, a
     loss line a step with the method's terms, scores in [0, 1],
     checkpoints.
 20. the library-only models (ROADMAP item 11g; ``library_models``),
     default route, full width, seeded weights: (a) norm_type 3
     (GSNorm): a Joint eval forward at batch 1 on phase 3's phantom, on
     the default draw and on the conditioned draw (``condition_gsnorm``:
     on the default draw a GSNorm's channel sums come near 0 and the pass
     is chaotic), and a vae_train step at batch 4 on phase 5's train cases
     on the conditioned draw; (b) a norm_type 2 (BatchNorm) SegUNet forward
     at batch 2 on phase 5's train images; (c) a SegmentationGS forward at
     batch 1, then GSConv3d (3^3; 2^3 stride 2), SConv3d and
     GSConvTranspose3d (2^3 stride 2) once each on the card. Every kernel
     call of each pass, forward and backward, against its plain version
     under phases 2 and 5's rules, untimed, two more launches for the same
     bits, and each K1 call (no prologue, no epilogue) also by the stored-y
     bound of phase 2's stats calls, each element within one bf16 ulp of
     the f64 conv beyond the f32 sum's error (``k1_y_checks``: its flips
     reported), which a planted 1% fault in one call must fail; launches
     derived from the model; each forward's outputs finite, its
     probabilities summing to 1, a second kernel-path pass equal bit
     for bit, and but on the default norm_type 3 draw the probabilities
     within ``DRIFT_MULTIPLE`` times the plain path's reordered drift;
     (b)'s running buffers within F32_TOL of their largest element or
     ``DRIFT_MULTIPLE`` times their reordered drift; the step by
     ``gate_step`` on its gradients; ``forward_ms`` / ``step_ms``, peak
     memory and the profiler's device time of each.
 21. the ``kernels`` line (sixteen kernels; those of an opt-in route
     carry its switch in ``path`` and count their launches on its runs;
     the others count phase 14's CLI runs in ``launches_test_time_path``,
     phase 15's in ``launches_later_flags_path``, phase 18's in
     ``launches_serving_and_methods_path``, phase 19's in
     ``launches_remaining_methods_path`` and phase 20's checked passes in
     ``launches_library_models_path`` too; then the three K1 kernels
     with a range, their slab calls' totals and their launches on phase
     17(b)'s steps), then the last line ``{"ok": true, "device":
     {...}}``.
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
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 tensor cores (f32 operand)
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
PER_FORWARD = {"conv3": 58, "down_k2s2": 9, "up_k2s2": 9}
# the norm route (VAESEG_PALLAS=1): one InstanceNorm+ReLU per conv but the
# two heads of a Joint forward
PER_NORM_FORWARD = {**PER_FORWARD, "norm_stats": 56, "norm_apply": 56}
KERNEL_NAMES = ("conv3", "down_k2s2", "up_k2s2", "conv3_dk", "down_k2s2_bwd",
                "up_k2s2_bwd", "softmax_vjp", "dice_sums", "reparam_kl",
                "conv3_bwd", "norm_stats", "norm_apply", "norm_bwd_sums",
                "norm_bwd_dx", "dice_sums_vjp", "reparam_kl_vjp")
# the kernels that run only on an opt-in route: their launches are counted
# on that route's runs (phases 12 and 13)
NORM_KERNELS = ("norm_stats", "norm_apply", "norm_bwd_sums", "norm_bwd_dx")
# the kernels timed as a replayed CUDA graph beside their plain versions
# (check_step_calls): the norm kernels, whose deep calls are shorter than
# their enqueue, and the two VJPs, whose plain versions are eager chains
GRAPH_TIMED = NORM_KERNELS + ("dice_sums_vjp", "reparam_kl_vjp")
# K1's stats epilogue, each part held to what it computes (_compare):
# - its summation: the stats against the f64 sums of K1's own stored y (the
#   sum's error over sum |y|, the sumsq's relative error) within
#   K1_SUM_TOL. The block partials are f32 sums at most ~64 adds deep
#   (2^-24 an add, 3.8e-6 at worst) and parts_reduce adds them in f64.
K1_SUM_TOL = 1e-5
# - its stored y: against the f64 conv of the call's inputs rounded to bf16
#   once. Every element within one bf16 ulp of the f64 value beyond the f32
#   sum's own error, K1_F32_ERR of the sum of the terms' magnitudes (|w| |xn|
#   and |bias|: 64 times f32's unit roundoff, the depth of K1's sums, chains
#   of up to 24 truncating MMA accumulations folded by up to 54 rounded
#   adds; a sum that cancels cannot be nearer its f64 value, the plain
#   version's included); and its flips, the distinct values (a channel's
#   f64 value, counted once however many voxels share it) whose stored y
#   differs from the once-rounded value, at most twice the plain version's
#   and never fewer than K1_FLIP_FLOOR (the plain version may flip none).
#   Counted by element, a flip is a lottery on label-derived inputs: their
#   uniform regions give thousands of voxels one sum, and where that sum
#   lies within an f32 error of a rounding midpoint they all flip on one
#   path and not on the other.
K1_F32_ERR = 2.0 ** -17
K1_FLIP_FLOOR = 8
# f32 sums of a backward kernel (dk, db, ds/dt, Dice sums): max abs error
# over the tensor's largest element (the kernels add in another order than
# the plain versions; measured up to 2e-5 on an H100 over one train step at
# 128^3, batch 2)
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
    "dice_sums_vjp": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                      "losses.cu",
                      "vae_segmentation_tpu/ops/pallas/dicesums.py:130 "
                      "(_bwd, the VJP attached to _run's pallas_call at "
                      ":73)"),
    "reparam_kl_vjp": ("vae_segmentation_tpu_torch/ops/kernels/csrc/"
                       "reparam.cu",
                       "vae_segmentation_tpu/ops/pallas/reparam.py:146 "
                       "(_reparam_bwd, the VJP attached to _run's "
                       "pallas_call at :91)"),
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


def host_ms(torch, fn, n: int = 1000) -> float:
    """Host-clock time of one fn() call over n calls without a
    synchronisation between them: what a wrapper costs the host (its
    checks, allocations and enqueue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return ms


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
            ("dice_sums_vjp", losses, "dice_sums_vjp",
             losses.dice_sums_vjp_plain),
            ("reparam_kl_vjp", reparam, "reparam_kl_vjp",
             reparam.reparam_kl_vjp_plain),
            ("conv3_bwd", conv3, "conv3_bwd", conv3.conv3_bwd_plain),
            ("norm_stats", norm, "norm_stats", norm.norm_stats_plain),
            ("norm_apply", norm, "norm_apply", norm.fold_apply_plain),
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
    per-block partials give its statistics."""
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


def k1_reference(torch, x, weight, bias, pre, dlim=None) -> tuple:
    """(ref, mag) of a K1 call on its recorded inputs: ref the f64 conv of
    xn (the prologue rounded in f32 as the kernel rounds it, 0 on planes
    outside dlim) with the bf16 weight, plus bias, [B, D, H, W, C] f64; mag
    the sum of its terms' magnitudes (|xn| with |w|, plus |bias|), f32."""
    import torch.nn.functional as F

    from vae_segmentation_tpu_torch.ops import conv3

    xn = x.float() if pre is None else conv3._masked(
        conv3._affine_relu(x, pre), conv3._plane_mask(x, dlim))
    w = weight.to(torch.bfloat16)
    ref = F.conv3d(xn.double().permute(0, 4, 1, 2, 3), w.double(),
                   None if bias is None else bias.double(), padding=1)
    mag = F.conv3d(xn.abs().permute(0, 4, 1, 2, 3), w.float().abs(),
                   None if bias is None else bias.float().abs(), padding=1)
    return ref.permute(0, 2, 3, 4, 1), mag.permute(0, 2, 3, 4, 1)


def stats_of(torch, y):
    """[B, 2, C] (sum, sumsq) of y in f64."""
    y = y.double()
    return torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                       dim=1)


def stats_errors(st, want, abs_sum) -> list:
    """K1's measures of [B, 2, C] stats against `want`: the sum's error over
    sum |y|, the sumsq's relative error (largest over (B, C))."""
    st, want = st.double(), want.double()
    return [((st[:, 0] - want[:, 0]).abs() / abs_sum).max().item(),
            ((st[:, 1] - want[:, 1]).abs()
             / want[:, 1].clamp_min(1e-30)).max().item()]


def bf16_ulp(torch, v):
    """The spacing of bf16 values at |v| (f64): 2^(e - 8) for v = m 2^e,
    m in [0.5, 1); the smallest subnormal's at 0 and below."""
    e = torch.frexp(v).exponent
    ulp = torch.ldexp(torch.ones_like(v), (e - 8).clamp_min(-133))
    return torch.where(v == 0, torch.full_like(v, 2.0 ** -133), ulp)


def k1_y_rule(torch, y, ref, mag) -> tuple:
    """(elements beyond one bf16 ulp of the f64 value plus K1_F32_ERR of
    their terms' magnitudes, elements other than the once-rounded value,
    distinct values so flipped: a channel's f64 value counted once however
    many elements share it) of a stored bf16 y."""
    far = ((y.double() - ref).abs()
           > bf16_ulp(torch, ref) + K1_F32_ERR * mag.double())
    c = ref.shape[-1]
    ref2 = ref.reshape(-1, c)
    flip2 = (y != ref.to(torch.bfloat16)).reshape(-1, c)
    distinct = 0
    for ch in range(c):
        flip = flip2[:, ch]
        if bool(flip.any()):
            inv = torch.unique(ref2[:, ch], return_inverse=True)[1]
            distinct += torch.unique(inv[flip]).numel()
    return int(far.sum()), int(flip2.sum()), distinct


def _compare(torch, name, softmax, got, want, inputs=None):
    """Errors of one kernel call against the plain output, and whether
    they are inside the stated tolerances: y (bf16) within 1e-2 of the
    largest |y| (softmax probabilities 1e-2 abs). With the stats epilogue,
    `inputs` = (x, weight, bias, pre[, dlim]) of the call, and K1's two
    parts are
    each held to what they compute:
    - its summation: the stats against the f64 sums of its own stored y,
      each measure (the sum's error over sum |y|, sumsq relative) within
      K1_SUM_TOL;
    - its stored y against the f64 conv rounded to bf16 once
      (``k1_reference``): no element further than one bf16 ulp beyond the
      f32 sum's own error (``k1_y_rule``), and no more distinct values off
      the once-rounded value than twice the plain version's, or
      K1_FLIP_FLOOR (the elements off it are reported).
    The stats' distance from the f64 stats of the once-rounded conv, K1's
    and the plain version's, is reported, not gated: at 64 voxels a channel one bf16 flip of a large voxel moves a
    channel's sumsq by ~1.5e-3, whichever path flips."""
    stats = isinstance(want, tuple)
    yk, yp = (got[0], want[0]) if stats else (got, want)
    err = (yk.float() - yp.float()).abs().max().item()
    scale = yp.float().abs().max().item()
    rec = {"max_abs_err": err, "max_abs_y": scale}
    ok = err <= (1e-2 if softmax else 1e-2 * scale)
    if stats:
        sk, sp = got[1], want[1]
        ref, mag = k1_reference(torch, *inputs)
        abs_k = yk.double().abs().sum(dim=(1, 2, 3))
        abs_p = yp.double().abs().sum(dim=(1, 2, 3))
        own = stats_errors(sk, stats_of(torch, yk), abs_k)
        rec["stats_own_sum_err"], rec["stats_own_sumsq_rel"] = own
        rec["plain_stats_own"] = stats_errors(sp, stats_of(torch, yp), abs_p)
        far, elems, flips = k1_y_rule(torch, yk, ref, mag)
        far_p, elems_p, flips_p = k1_y_rule(torch, yp, ref, mag)
        n = yk.numel()
        limit = max(2 * flips_p, K1_FLIP_FLOOR)
        rec.update(y_beyond_ulp=far, plain_y_beyond_ulp=far_p,
                   y_flip_share=elems / n, plain_y_flip_share=elems_p / n,
                   y_flip_elements=elems, plain_y_flip_elements=elems_p,
                   y_flips=flips, plain_y_flips=flips_p, y_flip_limit=limit)
        exact = stats_of(torch, ref.to(torch.bfloat16))
        del ref, mag
        rec["stats_sum_err"], rec["stats_sumsq_rel"] = stats_errors(
            sk, exact, abs_p)
        rec["plain_stats_sum_err"], rec["plain_stats_sumsq_rel"] = \
            stats_errors(sp, exact, abs_p)
        rec["stats_vs_plain"] = stats_errors(sk, sp, abs_p)
        ok = (ok and all(e <= K1_SUM_TOL for e in own) and far == 0
              and flips <= limit and bool(torch.isfinite(sk).all()))
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
            got = kern()
            m = c["module"]
            rec = _compare(torch, name, softmax, got, c["out"],
                           (c["x"], m.weight, m.bias, c["pre"]))
            repeat = repeats_bitwise(torch, kern, got) \
                if name in REPEATS else None
        del got
        k = keys.setdefault(c["key"], {"count": 0, "first": c, "err": 0.0,
                                       "ok": True, "worst": rec,
                                       "repeat": repeat})
        k["count"] += 1
        k["ok"] = k["ok"] and rec["ok"]
        if repeat is False:
            k["repeat"] = False
            failures.append(f"{name} {shape}: two more launches gave "
                            "different bits")
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
        if k["repeat"] is not None:
            rec["repeat_bitwise"] = k["repeat"]
        with torch.no_grad():
            rec["kernel_ms"] = cuda_ms(torch, kern)
            rec["plain_ms"] = cuda_ms(torch, plain, budget_ms=20.0,
                                      max_reps=10)
            rec["library_ms"] = cuda_ms(torch, library)
            m = c["module"]
            if name == "conv3":
                rec.update(k1_variants(torch, kern, library, c["x"],
                                       m.kernel_weight(), m.bias, c["pre"],
                                       stats, softmax))
            else:
                rec.update(bridge_variants(
                    torch, kern, library, "up" if name == "up_k2s2"
                    else "down", c["x"], m.kernel_weight(), m.bias,
                    c["pre"]))
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
        add_variants(t, rec, n)
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
    ("conv3_bwd_kernel", "conv3_bwd"), ("bwd_dx_reduce_kernel", "conv3_bwd"),
    ("conv3_kernel", "conv3"),
    ("conv3_reduce_kernel", "conv3"),
    # the second pass of every fixed-order sum (common.cuh): K1's stats and
    # (ds, dt), the norm sums, dice_sums, K2's backward (ds, dt)
    ("parts_reduce_kernel", "parts_reduce"),
    ("down_dx_kernel", "down_k2s2_bwd/dx"), ("up_dx_kernel", "up_k2s2_bwd/dx"),
    ("down_kernel", "down_k2s2"), ("down_pre_kernel", "down_k2s2"),
    ("up_kernel", "up_k2s2"),
    ("softmax_vjp_c2_kernel", "softmax_vjp"),
    ("softmax_vjp_kernel", "softmax_vjp"), ("dice_sums_kernel", "dice_sums"),
    ("dice_sums_vec_kernel", "dice_sums"),
    ("dice_vjp_kernel", "dice_sums_vjp"),
    ("dice_vjp_vec_kernel", "dice_sums_vjp"),
    ("reparam_kl_kernel", "reparam_kl"),
    ("reparam_kl_vjp_kernel", "reparam_kl_vjp"),
    # phase 7's empty kernel: what a launch costs
    ("launch_floor_kernel", "launch_floor"))) + (
    # the split-K weight gradient and its reduction (wgrad.cuh) serve three
    # kernels of the table, by their mode: 0 K1, 1 K2, 2 K3
    (r"\bdk_kernel<0,", "conv3_dk"), (r"\bdk_reduce_kernel<0>", "conv3_dk"),
    (r"\bdk_kernel<1,", "down_k2s2_bwd/dk"),
    (r"\bdk_reduce_kernel<1>", "down_k2s2_bwd/dk"),
    (r"\bdk_kernel<2,", "up_k2s2_bwd/dk"),
    (r"\bdk_reduce_kernel<2>", "up_k2s2_bwd/dk"),
    # the merged conv backward's dk reduction (mode 3 names it)
    (r"\bdk_reduce_kernel<3>", "conv3_bwd"),
    # one template each serves two kernels of the table, by its mode (the
    # reduction's two plans: two passes, one launch)
    (r"\bnorm_reduce(?:_cluster)?_kernel<0\b", "norm_stats"),
    (r"\bnorm_reduce(?:_cluster)?_kernel<1\b", "norm_bwd_sums"),
    (r"\bnorm_elementwise_kernel<0\b", "norm_apply"),
    (r"\bnorm_elementwise_kernel<1\b", "norm_bwd_dx"))


CSRC = os.path.join(REPO, "vae_segmentation_tpu_torch", "ops", "kernels",
                    "csrc")


def port_kernel_names() -> list:
    """The __global__ functions of the port's CUDA sources."""
    names = set()
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, f)) as src:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s+)*"
                    r"(\w+)", src.read()))
    return sorted(names)


def _family(name: str) -> str:
    """The kernel family of a profiler event: a kernel of the table, or
    its dx / dk part for the bridge backwards."""
    for pattern, family in FAMILIES:
        if re.search(pattern, name):
            return family
    # cuBLAS on Hopper names its GEMMs nvjet_*
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "cutlass")):
        return "gemm"
    return "other"


def profile_run(torch, fn, reps: int, phase: str, failures: list) -> dict:
    """Device ms per call of fn() by kernel family (kernel events of
    ``torch.profiler``), host-clock wall ms per call, and their ratio, the
    device's busy share. A kernel of the port's sources that falls into
    "other" fails the run: FAMILIES must name it."""
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
    by_family, other, unnamed = {}, [], []
    # the port's kernels live in the namespace wgrad or an anonymous one at
    # the top level (a library's may share a name: at::native::...)
    port = re.compile(r"(?:^|\s)(?:wgrad::|\(anonymous namespace\)::)("
                      + "|".join(port_kernel_names()) + r")\b")
    for ev in prof.key_averages():
        # kernels only: a CPU op's device time repeats its kernels'
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        ms = ev.self_device_time_total / 1e3 / reps
        f = _family(ev.key)
        by_family[f] = by_family.get(f, 0.0) + ms
        if f == "other":
            other.append([ms, ev.key[:80]])
            if port.search(ev.key):
                unnamed.append(ev.key[:120])
    device_ms = sum(by_family.values())
    if unnamed:
        failures.append(f"{phase}: port kernels in no family: {unnamed}")
    return {"phase": phase, "reps": reps, "wall_ms": wall_ms,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "device_ms_by_family": by_family,
            "largest_other": sorted(other, reverse=True)[:5],
            "port_kernels_in_no_family": unnamed}


def device_kernels(torch, fn, reps: int = 20) -> list:
    """The names of the device activities (kernels, copies, fills) of one
    fn() call, by the profiler's events over reps calls (the first rep's
    share), or None where their count is no multiple of reps (a session
    that lost or gained events)."""
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
    if len(names) % reps:
        return None
    return names[:len(names) // reps]


# device kernels a norm forward or backward launches: the reduction's one
# or two and the elementwise pass
MIN_KERNELS_A_NORM, MAX_KERNELS_A_NORM = 2, 3
# the norms of the flagship Joint at 128^3 (fmaps 8-256), batch 1: the
# shapes of the norm route's eval forward
NORM_SHAPES = tuple((1, 128 >> k, 128 >> k, 128 >> k, 8 << k)
                    for k in range(6))


def kernels_per_norm(torch, shapes, failures) -> dict:
    """The device activities of one instance_norm_act forward and of its
    backward (norm_bwd on the forward's (s, t)) at each [B, D, H, W, C] of
    `shapes`, by the profiler; fewer than MIN_KERNELS_A_NORM or more than
    MAX_KERNELS_A_NORM either way fails the run. Run before any other
    profile: later in the process, short sessions lost their device
    events on an H100 (torch 2.11), and such a count is refused."""
    from vae_segmentation_tpu_torch.ops import instance_norm as N

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in shapes:
        x = (torch.randn(shape, device="cuda", generator=gen) * 3 + 1) \
            .bfloat16()
        g = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        with torch.no_grad():
            _, s, t = N.norm_apply(x, N.norm_stats(x, f64=True))
            fwd = device_kernels(torch, lambda: N.instance_norm_act(x))
            bwd = device_kernels(torch, lambda: N.norm_bwd(x, g, s, t))
        out[str(list(shape))] = {"forward": fwd, "backward": bwd}
        if not all(k is not None and MIN_KERNELS_A_NORM <= len(k)
                   <= MAX_KERNELS_A_NORM for k in (fwd, bwd)):
            failures.append(f"a norm at {list(shape)} launches {fwd} "
                            f"forward, {bwd} backward (by the profiler; "
                            f"{MIN_KERNELS_A_NORM}-{MAX_KERNELS_A_NORM} "
                            "each way)")
    return out


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


def profile_forward(torch, model, image, failures: list, reps: int = 5,
                    phase: str = "profile") -> dict:
    """Phase 4: where the eval forward's device time goes."""
    def forward():
        with torch.no_grad():
            model(image)
    return profile_run(torch, forward, reps, phase, failures)


def profile_step(torch, fn, step_ms: float, phase: str, log: list,
                 failures: list) -> None:
    """Where a train step's device time goes (profile_run over 2 calls of
    fn), emitted; the profiler slows the host, so also the device time over
    the unprofiled step_ms."""
    prof = profile_run(torch, fn, 2, phase, failures)
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
    if k in ("reparam_kl", "reparam_kl_vjp"):
        return {"kernel": k, "shape": list(a["mean"].shape)}
    if k == "softmax_vjp":
        return {"kernel": k, "shape": list(a["y"].shape)}
    if k == "dice_sums":
        return {"kernel": k, "shape": list(a["pred"].shape),
                "targets": len(a["targets"])}
    if k == "dice_sums_vjp":
        kk = len(a["targets"])
        return {"kernel": k, "shape": list(a["pred"].shape), "targets": kk,
                "need": [bool(a["need_pred"])]
                + [bool(f) for f in a["need_targets"][:kk]]}
    if k in NORM_KERNELS:
        d = {"kernel": k, "shape": list(a["x"].shape)}
        if "relu" in a:
            d["relu"] = bool(a["relu"])
        return d
    d = {"kernel": k, "shape": list(a["x"].shape),
         "pre": a.get("pre") is not None}
    if a.get("dlim") is not None:
        d["dlim"] = list(a["dlim"])
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
    the two elementwise kernels against the f32 peak. A weight gradient
    under K1's or K2's prologue multiplies an f32 operand (xn) and counts
    against the TF32 tensor-core peak; a bridge backward that also
    computes dx (bf16) gets the rate of the mix."""
    k, shape = d["kernel"], d["shape"]
    if k == "reparam_kl":
        return reparam_work(shape[0] * shape[1])
    if k == "reparam_kl_vjp":
        # reads mean, std, eps and g_latent, writes d_mean and d_std (f32);
        # 2 operations an element for d_mean, 7 for d_std (the reciprocal
        # one)
        n = shape[0] * shape[1]
        return 24 * n + 4, 9 * n, F32_FLOPS_PER_S
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
    if k == "dice_sums_vjp":
        # reads g, pred where a d t_k is needed and the targets where dp is;
        # writes each needed gradient (bf16); a product and a sum an
        # element for each target of dp and for each d t_k
        t, (need_p, *need_t) = d["targets"], d["need"]
        vols = t * need_p + any(need_t) + need_p + sum(need_t)
        return (2 * n * c * vols + 4 * b * (1 + 2 * t) * c,
                2 * n * c * (t * need_p + sum(need_t)), F32_FLOPS_PER_S)
    if k in NORM_KERNELS:
        # bf16 volumes read (x; g in the backward) and written (y, dx);
        # bytes a (b, c): the reductions write their f64 [B, 2, C] sums (16;
        # norm_bwd_sums also reads (s, t), 8), norm_apply reads the f64 sums
        # and writes (s, t) (24), norm_bwd_dx reads (s, t) and the f64 sums
        # (24); operations an element: sum and square (2), affine and ReLU
        # (3), affine, mask and two products (5), affine, mask and the dx
        # expression (7), and a (b, c)'s fold (8: two means, mean^2, the
        # variance, clamp, eps, rsqrt, shift; norm_bwd_dx its two means)
        vols, small, ops, fold = {
            "norm_stats": (1, 16, 2, 0), "norm_apply": (2, 24, 3, 8),
            "norm_bwd_sums": (2, 24, 5, 0), "norm_bwd_dx": (3, 24, 7, 2)}[k]
        return 2 * n * c * vols + small * b * c, \
            ops * n * c + fold * b * c, F32_FLOPS_PER_S
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
    dk_rate = TF32_FLOPS_PER_S if pre else BF16_FLOPS_PER_S
    if k == "conv3_dk":
        return (2 * n * c + 2 * n * cout + 4 * 27 * c * cout + 4 * cout + aff,
                2 * n * 27 * c * cout, dk_rate)
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
    part = 2 * coarse * 8 * c * cout
    flops = part * (int(dx) + int(dk))
    seconds = part * (int(dx) / BF16_FLOPS_PER_S + int(dk) / dk_rate)
    return nbytes, flops, flops / seconds if flops else BF16_FLOPS_PER_S


def _outputs(out) -> list:
    """The tensors of a wrapper's result, in order (None kept)."""
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare_call(torch, d: dict, got, want, args: dict) -> dict:
    """Errors of one kernel call (bound arguments `args`) against the
    recorded plain result: bf16 outputs within 1e-2 of the largest |want|
    (softmax probabilities 1e-2 abs), f32 sums within F32_TOL of their
    tensor's largest element; a forward conv with stats keeps phase 2's
    rule. Outputs the kernel was told to skip (None) are not compared."""
    if d["kernel"] == "conv3" and d.get("stats"):
        return _compare(torch, "conv3", False, got, want,
                        (args["x"], args["weight"], args["bias"],
                         args["pre"], args.get("dlim")))
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
        if g.dtype in (torch.float32, torch.float64):
            rec["f32_rel_err"] = max(rec["f32_rel_err"], err / scale)
            ok = err <= F32_TOL * scale
        else:
            rec["bf16_rel_err"] = max(rec["bf16_rel_err"], err / scale)
            ok = err <= (1e-2 if d.get("softmax") else 1e-2 * scale)
        rec["ok"] = rec["ok"] and ok and bool(torch.isfinite(g).all())
    if d["kernel"] in BITWISE:
        rec["bitwise"] = all(g is None or torch.equal(g, w) for g, w in zip(
            _outputs(got), _outputs(want)))
        rec["ok"] = rec["ok"] and rec["bitwise"]
    return rec


# the kernels that round as their plain versions do, each operation once:
# every output equal to the plain version's on the same inputs (y, s and t
# of norm_apply's fold; norm_bwd_dx with its means; softmax_vjp; the Dice
# sums' and the reparam's VJPs)
BITWISE = ("softmax_vjp", "norm_apply", "norm_bwd_dx", "dice_sums_vjp",
           "reparam_kl_vjp")


def on_kernel_sums(torch, kernel: str, a: dict) -> bool:
    """A recorded norm_apply / norm_bwd_dx call again on the f64 sums its
    reduction's kernel gives (the recording hands it the plain version's
    f32 sums, widened, whose rounding to f32 is exact): kernel and plain
    version equal bit for bit, output by output."""
    from vae_segmentation_tpu_torch.ops import instance_norm as N

    if kernel == "norm_apply":
        args = {**a, "sums": N.norm_stats(a["x"], f64=True)}
        got, want = N.norm_apply(**args), N.fold_apply_plain(**args)
    else:
        args = {**a, "sums": N.norm_bwd_sums(a["x"], a["g"], a["s"], a["t"],
                                             a["relu"], f64=True)}
        got, want = N.norm_bwd_dx(**args), N.norm_bwd_dx_plain(**args)
    return all(torch.equal(g, w) for g, w in zip(_outputs(got),
                                                 _outputs(want)))


def conv3_dk_exact(torch, a: dict) -> tuple:
    """dk, db of a recorded conv3_dk call in f64: the prologue rounded in
    f32 as the kernel rounds it, each product of an f32 value and a bf16
    cotangent exact in f64, the sums f64 (to 1e-16 of their terms)."""
    from vae_segmentation_tpu_torch.ops import conv3

    x, gy, pre = a["x"], a["gy"], a.get("pre")
    xin = (x.float() if pre is None else conv3._masked(
        conv3._affine_relu(x, pre),
        conv3._plane_mask(x, a.get("dlim")))).double()
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
    as reparam_kl does, nor their VJPs."""
    import torch.nn.functional as F

    k = d["kernel"]
    if k == "softmax_vjp":
        return lambda: torch.ops.aten._softmax_backward_data(
            a["g"], a["y"], -1, torch.bfloat16)
    if k in ("dice_sums", "reparam_kl", "norm_bwd_sums", "dice_sums_vjp",
             "reparam_kl_vjp"):
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
                             "pre": ak["pre"], "dlim": ak.get("dlim")},
                    "out": (dx, *dk_call["out"], dst)})
    return out


# the kernels whose sums are all added in a fixed order (no kernel of the
# port adds with atomics): two more launches on a recorded call must give
# every output's bits again (K1's y and its stats or (ds, dt), K2's and K3's
# y, the weight gradients, the bridge backwards' dx and K2's (ds, dt), the
# merged backward's dx, dk, db and (ds, dt), the Dice and norm sums)
REPEATS = ("conv3", "down_k2s2", "up_k2s2", "conv3_dk", "down_k2s2_bwd",
           "up_k2s2_bwd", "conv3_bwd", "dice_sums", "norm_stats",
           "norm_bwd_sums") + BITWISE
BRIDGE_BWD = ("down_k2s2_bwd", "up_k2s2_bwd")


def repeats_bitwise(torch, run, got) -> bool:
    """Whether two more calls of run() give the bits of `got`, output by
    output."""
    want = [t for t in _outputs(got) if t is not None]
    for _ in range(2):
        again = [t for t in _outputs(run()) if t is not None]
        if len(again) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(want, again)):
            return False
    return True


def k1_variants(torch, kern, library, x, kweight, bias, pre, stats, softmax,
                post=None) -> dict:
    """K1's plan for one call (its K splits, tile and channel chunk); the
    device time of the call (kern) and of its library call as a replayed
    CUDA graph (a K1 call at 4^3-32^3 runs for less time than its wrapper
    takes to enqueue it, so CUDA events around repeated calls time the
    host there); and, where the plan splits K, the one-pass plan's time on
    the same inputs by both clocks (the split plan's are the call's)."""
    from vae_segmentation_tpu_torch.ops import conv3

    b, d, h, w, cin = x.shape
    epi = "stats" if stats else "softmax" if softmax \
        else "post" if post is not None else "none"
    key = (b, (d, h, w), cin, kweight.shape[-1], pre is not None, epi,
           conv3.sm_count(x.device.index or 0))
    plan = conv3.conv3_plan(*key)
    rec = {"splits": plan["splits"], "tile": [plan["td"], plan["th"],
                                              plan["tw"]], "co": plan["co"],
           "graph_ms": graph_ms(torch, kern),
           "library_graph_ms": graph_ms(torch, library)}
    if plan["splits"] > 1:
        one = conv3.conv3_plan(*key, splits=1)

        def onepass():
            return conv3.conv3_launch(x, kweight, bias, one, pre, post)
        rec["onepass_ms"] = cuda_ms(torch, onepass)
        rec["onepass_graph_ms"] = graph_ms(torch, onepass)
    return rec


def bridge_variants(torch, kern, library, kind: str, x, kweight, bias,
                    pre) -> dict:
    """K2's or K3's plan for one call (its brick, K split over the warps,
    bricks a block, route); the device time of the call (kern) and of its
    cuDNN call as a replayed CUDA graph (a deep call is shorter than its
    enqueue, so CUDA events time the host there); and, where the plan
    splits K over the warps (``splits`` = wk > 1), the one-pass plan's time
    on the same inputs by both clocks."""
    from vae_segmentation_tpu_torch.ops import bridges, conv3

    b, d, h, w, cin = x.shape
    key = (kind, b, (d, h, w), cin, kweight.shape[-1], pre is not None,
           conv3.sm_count(x.device.index or 0))
    plan = bridges.bridge_plan(*key)
    rec = {"splits": plan["wk"], "tile": [plan["td"], plan["th"], plan["tw"]],
           "co": plan["nc"], "bricks_a_block": plan["tpb"],
           "tensor_cores": plan["tensor_cores"],
           "graph_ms": graph_ms(torch, kern),
           "library_graph_ms": graph_ms(torch, library)}
    if plan["wk"] > 1:
        one = bridges.bridge_plan(*key, wk=1)

        def onepass():
            return bridges.bridge_launch(kind, x, kweight, bias, pre, one)
        rec["onepass_ms"] = cuda_ms(torch, onepass)
        rec["onepass_graph_ms"] = graph_ms(torch, onepass)
    return rec


def add_variants(t: dict, rec: dict, n: int) -> None:
    """Sum K1's, K2's and K3's device times (graph_ms, library_graph_ms)
    and variants into a kernel's totals: the calls whose plan splits K,
    their time under it (split_ms, split_graph_ms) and under the one-pass
    plan (onepass_ms, onepass_graph_ms)."""
    if "splits" not in rec:
        return
    for f in ("graph_ms", "library_graph_ms", "split_calls", "split_ms",
              "onepass_ms", "split_graph_ms", "onepass_graph_ms"):
        t.setdefault(f, 0.0)
    t["graph_ms"] += n * rec["graph_ms"]
    t["library_graph_ms"] += n * rec["library_graph_ms"]
    if rec["splits"] > 1:
        t["split_calls"] += n
        t["split_ms"] += n * rec["kernel_ms"]
        t["onepass_ms"] += n * rec["onepass_ms"]
        t["split_graph_ms"] += n * rec["graph_ms"]
        t["onepass_graph_ms"] += n * rec["onepass_graph_ms"]


# K2's dx alone, summed over a pass (down_dx_variants)
DX_FIELDS = ("dx_graph_ms", "dx_library_ms", "dx_library_graph_ms",
             "dx_bound_ms")


def down_dx_variants(torch, wrapper, d: dict, a: dict) -> dict:
    """K2's dx alone on a recorded down_k2s2_bwd call (its kernel and,
    under the prologue, the second pass of (ds, dt)): its plan, its device
    time as a replayed CUDA graph, the dx-only library call
    (``aten.convolution_backward``, output mask (T, F, F)) by CUDA events
    and as a graph, and the bound of dx alone."""
    from vae_segmentation_tpu_torch.ops import bridges, conv3

    x = a["x"]
    dx_d = {**d, "need_dk": False}
    library = _library_fn(torch, dx_d, a)
    plan = bridges.down_dx_plan(
        x.shape[0], tuple(x.shape[1:4]), x.shape[-1], d["cout"], d["pre"],
        conv3.sm_count(x.device.index or 0))
    nbytes, flops, peak = op_work(dx_d)
    return {"dx_graph_ms": graph_ms(torch, lambda: wrapper(**{
                **a, "need_dk": False})),
            "dx_library_ms": cuda_ms(torch, library),
            "dx_library_graph_ms": graph_ms(torch, library),
            "dx_bound_ms": max(1e3 * nbytes / HBM_BYTES_PER_S,
                               1e3 * flops / peak),
            "dx_plan": {k: plan[k] for k in bridges.DOWN_DX_FIELDS}}


# the norm reduction's two plans, summed over a pass where one launch can
# take the calls (norm_plans)
PLAN_FIELDS = ("one_launch_graph_ms", "two_passes_graph_ms")


def norm_plans(torch, d: dict, a: dict) -> dict:
    """The plan a recorded norm_stats / norm_bwd_sums call took (one launch
    or two passes) and, where one launch can take the call, both plans'
    device time as a replayed CUDA graph on its inputs."""
    from vae_segmentation_tpu_torch.ops import instance_norm as N

    x, g = a["x"], a.get("g")
    plan = N.reduce_plan(x, g)
    rec = {"plan": "one launch" if plan["one_launch"] else "two passes",
           "plan_parts": plan["parts"]}
    b, c = x.shape[0], x.shape[-1]
    lanes = 8 if c % 8 == 0 else 1
    if plan["lanes"] != 8 or c > N.NORM_CLUSTER_MAX_C \
            or (c // lanes) & (c // lanes - 1):
        return rec
    kw = {} if g is None else {"g": g, "aff": (a["s"], a["t"])}
    relu = bool(a.get("relu", False))
    for one, f in ((True, "one_launch_graph_ms"),
                   (False, "two_passes_graph_ms")):
        forced = N.norm_reduce_plan(b, x.numel() // (b * c), c, True,
                                    N.sm_count(x.device.index or 0),
                                    one_launch=one)
        rec[f] = graph_ms(torch, lambda: N._launch(d["kernel"], x, relu,
                                                   plan=forced, **kw))
    return rec


def check_calls(torch, calls, failures, phase: str) -> dict:
    """Every recorded kernel call, kernel on the plain path's inputs against
    the plain path's outputs (compare_call, exact_compare for EXACT), and
    two more launches of each REPEATS kernel against the first's bits.
    Returns {distinct call: {"count", "first" call, "desc", "ok", "worst"
    record, "repeat"}}."""
    real = {name: getattr(mod, attr) for name, mod, attr, _ in kernel_ops()}
    keys = {}
    with torch.no_grad():
        for c in calls:
            d = describe(c)
            wrapper = real[d["kernel"]]
            got = wrapper(**c["args"])
            rec = compare_call(torch, d, got, c["out"], c["args"])
            if d["kernel"] in EXACT:
                rec = exact_compare(torch, d["kernel"], c["args"], got,
                                    c["out"], rec)
            if d["kernel"] in ("norm_apply", "norm_bwd_dx"):
                rec["bitwise_on_kernel_sums"] = on_kernel_sums(
                    torch, d["kernel"], c["args"])
                rec["ok"] = rec["ok"] and rec["bitwise_on_kernel_sums"]
            repeat = repeats_bitwise(
                torch, lambda: wrapper(**c["args"]), got) \
                if d["kernel"] in REPEATS else None
            del got
            k = keys.setdefault(json.dumps(d, sort_keys=True),
                                {"count": 0, "first": c, "desc": d,
                                 "ok": True, "worst": rec,
                                 "repeat": repeat})
            k["count"] += 1
            k["ok"] = k["ok"] and rec["ok"]
            if repeat is False:
                k["repeat"] = False
                failures.append(f"{phase}: {d}: two more launches gave "
                                "different bits")
            if _worst_rel(rec) >= _worst_rel(k["worst"]):
                k["worst"] = rec
    torch.cuda.synchronize()
    return keys


def check_step_calls(torch, calls, log, failures,
                     phase: str = "step_kernel") -> dict:
    """Phases 5 and 8: every kernel call of a recorded train step checked
    (check_calls); each distinct call also timed (kernel, plain, library)
    and bounded. Returns per-kernel totals over the step."""
    from vae_segmentation_tpu_torch.ops import conv3

    real = {name: (getattr(mod, attr), plain)
            for name, mod, attr, plain in kernel_ops()}
    keys = check_calls(torch, calls, failures, phase)
    totals = {}
    for k in keys.values():
        d, a = k["desc"], k["first"]["args"]
        wrapper, plain = real[d["kernel"]]
        pargs = _plain_args(plain, a)
        library = _library_fn(torch, d, a)
        rec = {"phase": phase, **d, "calls_per_step": k["count"],
               **k["worst"], "ok": k["ok"]}
        if k["repeat"] is not None:
            rec["repeat_bitwise"] = k["repeat"]
        with torch.no_grad():
            if d["kernel"] in ("norm_stats", "norm_bwd_sums"):
                rec.update(norm_plans(torch, d, a))
            if d["kernel"] in GRAPH_TIMED:
                # a norm kernel at 4^3-64^3 or a VJP of [4, 128] runs for
                # less time than its wrapper takes to enqueue it, so CUDA
                # events around repeated calls time the host (kept beside):
                # these calls, their plain versions and their library calls
                # are timed as a replayed CUDA graph
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
            if d["kernel"] == "softmax_vjp":
                # also as a replayed CUDA graph, beside its library call
                rec.update(graph_ms=graph_ms(torch, lambda: wrapper(**a)),
                           library_graph_ms=graph_ms(torch, library))
            if d["kernel"] == "dice_sums":
                # also as a replayed CUDA graph (its two launches' device
                # time) beside the plain version's
                rec.update(graph_ms=graph_ms(torch, lambda: wrapper(**a)),
                           plain_graph_ms=graph_ms(torch,
                                                   lambda: plain(**pargs)))
            if d["kernel"] == "conv3_bwd":
                # the pair it replaces and its library call, also as a
                # replayed CUDA graph (a deep call is shorter than its
                # enqueue, so events time the host there)
                x = a["x"]
                plan = conv3.conv3_bwd_plan(
                    x.shape[0], tuple(x.shape[1:4]), x.shape[-1],
                    d["cout"], d["pre"], conv3.sm_count(x.device.index or 0))
                pair = pair_fn(a)
                rec.update(pair_ms=cuda_ms(torch, pair),
                           graph_ms=graph_ms(torch, lambda: wrapper(**a)),
                           pair_graph_ms=graph_ms(torch, pair),
                           library_graph_ms=graph_ms(torch, library),
                           plan_tile=[plan["td"], plan["th"], plan["tw"]],
                           plan_splits=plan["splits"],
                           plan_co_chunks=plan["co_chunks"])
            if d["kernel"] in BRIDGE_BWD:
                # each part alone: what a frozen weight or an input without
                # gradient launches
                rec["dx_ms"] = rec["dk_ms"] = 0.0
                if d["need_dx"]:
                    rec["dx_ms"] = rec["kernel_ms"] if not d["need_dk"] \
                        else cuda_ms(torch, lambda: wrapper(
                            **{**a, "need_dk": False}))
                if d["need_dk"]:
                    rec["dk_ms"] = rec["kernel_ms"] if not d["need_dx"] \
                        else cuda_ms(torch, lambda: wrapper(
                            **{**a, "need_dx": False}))
                if d["kernel"] == "down_k2s2_bwd" and d["need_dx"]:
                    rec.update(down_dx_variants(torch, wrapper, d, a))
            if d["kernel"] == "conv3":
                rec.update(k1_variants(
                    torch, lambda: wrapper(**a), library, a["x"],
                    a["kweight"], a["bias"], a["pre"], a["stats"],
                    a["softmax"], a["post"]))
            if d["kernel"] in ("down_k2s2", "up_k2s2"):
                rec.update(bridge_variants(
                    torch, lambda: wrapper(**a), library,
                    "up" if d["kernel"] == "up_k2s2" else "down", a["x"],
                    a["kweight"], a["bias"], a.get("pre")))
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
        for f in ("pair_ms", "dx_ms", "dk_ms", "pair_graph_ms",
                  "kernel_events_ms") + DX_FIELDS + PLAN_FIELDS:
            if f in rec:
                t[f] = t.get(f, 0.0) + k["count"] * rec[f]
        for f in ("graph_ms", "library_graph_ms", "plain_graph_ms"):
            if d["kernel"] in ("conv3_bwd", "softmax_vjp", "dice_sums") \
                    and f in rec:
                t[f] = t.get(f, 0.0) + k["count"] * rec[f]
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
        add_variants(t, rec, n)
    return totals


def check_untimed(torch, calls, log, failures, phase: str) -> dict:
    """check_step_calls' rules without its timing: every recorded call
    held against its plain version and repeated (check_calls), a record a
    distinct call. Returns per-kernel totals (calls, largest error, ok)."""
    totals = {}
    for k in check_calls(torch, calls, failures, phase).values():
        d = k["desc"]
        rec = {"phase": phase, **d, "calls_per_pass": k["count"],
               **k["worst"], "ok": k["ok"]}
        if k["repeat"] is not None:
            rec["repeat_bitwise"] = k["repeat"]
        emit(rec, log)
        if not rec["ok"]:
            failures.append(f"{phase}: {d} disagrees with its plain version")
        name = d["kernel"] + ("" if d.get("role", "fwd") == "fwd" else "/dx")
        t = totals.setdefault(name, {"calls": 0, "err": 0.0, "ok": True})
        t["calls"] += k["count"]
        t["err"] = max(t["err"], rec["max_abs_err"])
        t["ok"] = t["ok"] and rec["ok"]
    return totals


# ---- the train path


def expected_step_launches(joint) -> dict:
    """Kernel launches of one adaptation step (no KL term, one MC pass),
    derived from the model: the teacher's Seg forward, the student's Joint
    forward, a dx conv for every conv but the Seg's entry conv (the image
    needs no gradient), a weight gradient for the Seg's convs only (the VAE
    is frozen; its bridges' backwards skip dk and db), the softmax VJP of
    both heads, one fused Dice-sums pass and its VJP."""
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
            "dice_sums_vjp": 1, "reparam_kl": 0}


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
    ``expected_step_launches`` counts less the forwards and the Dice sums
    (their VJP stays)."""
    step, fwd = expected_step_launches(joint), PER_FORWARD
    seg_conv = step["conv3_dk"]
    return {**{k: 0 for k in KERNEL_NAMES},
            "conv3": step["conv3"] - seg_conv - fwd["conv3"],
            "conv3_dk": seg_conv, "down_k2s2_bwd": step["down_k2s2_bwd"],
            "up_k2s2_bwd": step["up_k2s2_bwd"], "softmax_vjp": 2,
            "dice_sums_vjp": step["dice_sums_vjp"]}


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


def gate_step(ops, record_checked, name: str, step1, want: dict,
              shuffled: bool = False) -> tuple:
    """The rule of phases 15, 18 and 19 on one train step from seeded
    weights. ``step1(lr=the step's)`` takes the step on fresh weights and
    returns (its loss terms {term: float}, the update of every tensor it
    trains {key: tensor}, whether every tensor it freezes is unchanged).
    - Every kernel call of the step, at lr 0, against its plain version
      (``record_checked``: untimed, bit for bit on repeat).
    - The step on the kernel path launches `want`.
    - Each loss term within DRIFT_MULTIPLE times its largest drift over the
      plain path's other summation orders: the convs' sums split by
      channels and, with `shuffled` (phase 19's default-route steps with a
      reparam KL), also K1's norm statistics summed in three shuffled
      orders, phase 9's orders. The floor is phase 9's: 1e-3 of the term, or 1e-3 where the
      term is below 1.
    - Every trained tensor's update within DRIFT_MULTIPLE times the plain
      path's drift (``drift_ratios``, the split-channel order), every
      trained weight moved, every frozen tensor unchanged.
    Returns (record, ok, the kernel calls' totals)."""
    _, totals, calls = record_checked(
        lambda: step1(0.0), want, f"{name}_step_kernel", f"{name} step",
        timed=False)
    del calls
    with plain_ops(reordered=True):
        loss_r, upd_r, _ = step1()
    with plain_ops():
        loss_p, upd_p, _ = step1()
    orders = [loss_r]
    for seed in (1, 2, 3) if shuffled else ():
        with plain_ops(reordered=True, stats_seed=seed):
            orders.append(step1()[0])
    ops.reset_launch_counts()
    loss_k, upd_k, still = step1()
    got = ops.launch_counts()
    err, _, worst = drift_ratios(upd_k, upd_p, upd_r)
    moved = all(bool(v.any()) for k, v in upd_k.items()
                if k.endswith(".weight"))
    del upd_k, upd_p, upd_r
    loss_drift = {t: max(abs(o[t] - loss_p[t]) for o in orders)
                  for t in loss_p}
    loss_gate = {t: max(DRIFT_MULTIPLE * loss_drift[t],
                        1e-3 * max(1.0, abs(loss_p[t]))) for t in loss_p}
    loss_err = {t: abs(loss_k[t] - loss_p[t]) for t in loss_p}
    ok = (got == want and still and moved
          and all(loss_err[t] <= loss_gate[t] for t in loss_p)
          and all(v <= DRIFT_MULTIPLE for v in worst.values()))
    rec = {"launches": got, "launches_expected": want,
           "losses_kernels": loss_k, "losses_plain": loss_p,
           "losses_other_orders": orders, "loss_drift": loss_drift,
           "loss_err": loss_err, "loss_gate": loss_gate,
           "update_tensors": len(err),
           "update_worst_ratio": max(worst.values()),
           "update_worst_tensor": max(worst, key=worst.get),
           "update_median_ratio": sorted(worst.values())[len(worst) // 2],
           "frozen_unchanged": still, "trained_moved": moved,
           "drift_multiple": DRIFT_MULTIPLE, "gate_ok": ok}
    return rec, ok, totals


def _mean_abs(a, b) -> float:
    return (a.float() - b.float()).abs().mean().item()


# ---- phase 9's rule: the vae_train step 1, each loss term where it is
# well conditioned

KL_WEIGHT = 2e-5            # make_vae_train_step's kl_weight


def vae_terms(torch, vae, batch, gen) -> dict:
    """A vae_train step 1's forward (make_vae_train_step: encoder, reparam
    draw from `gen`, decoder) with each loss term's gradient taken alone
    (two autograd.grad calls): the terms' values, the Dice term's and the
    KL term's (KL_WEIGHT * KL) gradients, the encoder's mean and std."""
    from vae_segmentation_tpu_torch.ops import losses as L

    onehot = L.one_hot_label(batch, 2)
    mean, std = vae.encode(onehot)
    latent, klv = vae.reparameterize(mean, std, VAE_SCALE, gen)
    dice = 1.0 - L.avg_dsc(vae.decode(latent), onehot, botindex=1,
                           topindex=2, eps=L.SOURCE_EPS)
    names, params = zip(*vae.named_parameters())
    gd = torch.autograd.grad(dice, params, retain_graph=True)
    gk = torch.autograd.grad(KL_WEIGHT * klv, params, allow_unused=True)
    torch.cuda.synchronize()
    return {"losses": {"dice_loss": dice.item(), "kl_loss": klv.item()},
            "grads_dice": dict(zip(names, gd)),
            "grads_kl": {n: g for n, g in zip(names, gk) if g is not None},
            "mean": mean.detach(), "std": std.detach()}


def vae_gate(torch, k: dict, p: dict, r: dict, shuffled: list) -> dict:
    """Phase 9's rule on a kernel-path vae_terms `k` against the plain
    path's `p`, with the plain path's own drift from its other summation
    orders: `r` (the convs' sums split by channels) and `shuffled` (r with
    K1's norm statistics also summed in shuffled orders).
    - Each loss term within DRIFT_MULTIPLE times its largest drift over the
      plain orders (1e-3 at least).
    - The Dice term's gradient, end to end, within DRIFT_MULTIPLE times the
      plain path's drift (drift_ratios against r).
    - The latent: mean |mean - plain mean| and mean |std - plain std| within
      DRIFT_MULTIPLE times the largest of the plain orders'.
    The KL term's gradient is not held end to end: std = relu(fc_std(z)),
    and the KL's gradient in std, std - 1 / (std + 1e-5), reaches 1e5 where a
    path lands a unit's std in (0, 1e-3), which a reordered plain sum does as
    often as the kernels (ROADMAP queue 3); its end-to-end ratio is reported,
    and phase 9 holds it on one shared forward (vae_backward_gate)."""
    orders = [r, *shuffled]
    terms = list(p["losses"])

    def rel(a, t):
        return abs(a["losses"][t] - p["losses"][t]) / abs(p["losses"][t])

    loss_err = {t: rel(k, t) for t in terms}
    by_order = [{t: rel(o, t) for t in terms} for o in orders]
    loss_drift = {t: max(o[t] for o in by_order) for t in terms}
    loss_gate = {t: max(DRIFT_MULTIPLE * v, 1e-3)
                 for t, v in loss_drift.items()}
    derr, ddrift, dworst = drift_ratios(k["grads_dice"], p["grads_dice"],
                                        r["grads_dice"])
    latent = {}
    for f in ("mean", "std"):
        od = [_mean_abs(o[f], p[f]) for o in orders]
        latent[f] = {"kernel_vs_plain": _mean_abs(k[f], p[f]),
                     "orders_vs_plain": od,
                     "gate": DRIFT_MULTIPLE * max(od)}
    # what the whole step's gate read for the KL term: its gradient, where
    # the plain path's is not zero
    kl_keys = [n for n, g in p["grads_kl"].items() if bool(g.any())]
    _, _, klworst = drift_ratios({n: k["grads_kl"][n] for n in kl_keys},
                                 {n: p["grads_kl"][n] for n in kl_keys},
                                 {n: r["grads_kl"][n] for n in kl_keys})
    finite = all(bool(torch.isfinite(g).all())
                 for g in k["grads_dice"].values()) \
        and all(bool(torch.isfinite(k[f]).all()) for f in ("mean", "std"))
    ok = (finite and sorted(k["grads_dice"]) == sorted(p["grads_dice"])
          and all(loss_err[t] <= loss_gate[t] for t in terms)
          and all(v <= DRIFT_MULTIPLE for v in dworst.values())
          and all(v["kernel_vs_plain"] <= v["gate"]
                  for v in latent.values()))
    return {"losses_kernels": k["losses"], "losses_plain": p["losses"],
            "loss_rel_err": loss_err, "loss_rel_drift": loss_drift,
            "loss_rel_drift_by_order": by_order, "loss_gate": loss_gate,
            "dice_grad_tensors": len(derr),
            "dice_grad_rel_l2_kernel_vs_plain": derr,
            "dice_grad_rel_l2_plain_vs_reordered": ddrift,
            "dice_worst_ratio": max(dworst.values()),
            "dice_worst_tensor": max(dworst, key=dworst.get),
            "dice_median_ratio": sorted(dworst.values())[len(dworst) // 2],
            "latent": latent,
            "kl_term_worst_ratio_not_gated": max(klworst.values()),
            "kl_term_worst_tensor": max(klworst, key=klworst.get),
            "finite": finite, "drift_multiple": DRIFT_MULTIPLE, "ok": ok}


def vae_backward_gate(torch, ops, vae, batch, gen, expected: dict) -> dict:
    """The KL term's half of phase 9: one vae_train forward on the kernel
    path (`vae` at step 1's weights, the reparam seed from `gen`), then the
    step's full loss, 1 - Dice + KL_WEIGHT * KL, backpropagated on that one
    graph by the kernels, by their plain versions and by the reordered
    plain versions: with the saved activations and the sampled eps fixed
    the backward is one linear map, so the KL term's gradient is well
    conditioned here where the end-to-end one is not. Every gradient tensor
    within DRIFT_MULTIPLE (drift_ratios); launches `expected`."""
    from vae_segmentation_tpu_torch.ops import losses as L

    onehot = L.one_hot_label(batch, 2)
    latent, klv = vae.reparameterize(*vae.encode(onehot), VAE_SCALE, gen)
    loss = 1.0 - L.avg_dsc(vae.decode(latent), onehot, botindex=1,
                           topindex=2, eps=L.SOURCE_EPS) + KL_WEIGHT * klv
    names, params = zip(*vae.named_parameters())

    def backward():
        grads = torch.autograd.grad(loss, params, retain_graph=True)
        torch.cuda.synchronize()
        return dict(zip(names, grads))

    ops.reset_launch_counts()
    got = backward()
    launches = ops.launch_counts()
    with plain_ops():
        want = backward()
    with plain_ops(reordered=True):
        other = backward()
    err, drift, worst = drift_ratios(got, want, other)
    ok = (launches == expected
          and all(bool(torch.isfinite(g).all()) for g in got.values())
          and all(v <= DRIFT_MULTIPLE for v in worst.values()))
    return {"backward_launches": launches,
            "backward_launches_expected": expected,
            "backward_grad_rel_l2_kernel_vs_plain": err,
            "backward_grad_rel_l2_plain_vs_reordered": drift,
            "backward_worst_ratio": max(worst.values()),
            "backward_worst_tensor": max(worst, key=worst.get),
            "backward_ok": ok}


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
    takes longer than the one-block kernel (both kept), and the wrapper's
    host time a call by the host clock (``host_ms``). An empty kernel
    (``reparam.cu::launch_floor_kernel``, one block of one thread) is
    timed both ways beside it: the least a launch costs, the kernel's real
    floor below its work bound. Returns its totals per step."""
    from vae_segmentation_tpu_torch.ops import reparam
    from vae_segmentation_tpu_torch.ops.conv3 import raise_if
    from vae_segmentation_tpu_torch.ops.kernels import build

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

    lib = build.library("reparam")
    stream = torch.cuda.current_stream().cuda_stream

    def floor():
        raise_if(lib.vaeseg_launch_floor(stream), lib, "launch_floor")

    with torch.no_grad():
        kernel_ms = profile_run(torch, kernel, 50, "", failures)["device_ms"]
        plain_ms = profile_run(torch, plain, 10, "", failures)["device_ms"]
        floor_ms = profile_run(torch, floor, 50, "", failures)["device_ms"]
        events_ms = [cuda_ms(torch, fn) for fn in (kernel, plain, floor)]
        wrapper_host_ms = host_ms(torch, kernel)
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
           "launch_floor_ms": floor_ms,
           "launch_floor_events_ms": events_ms[2],
           "wrapper_host_ms": wrapper_host_ms,
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
            "ops_ms": ops_ms, "calls": 1, "kernel_events_ms": events_ms[0],
            "launch_floor_ms": floor_ms,
            "launch_floor_events_ms": events_ms[2],
            "wrapper_host_ms": wrapper_host_ms}


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
    softmax VJP and, for the VAE, one reparam_kl and its VJP. The Dice loss
    is plain avg_dsc: no dice_sums."""
    fwd = forward_launches(net)
    return {**fwd, "conv3": 2 * fwd["conv3"] - 1,
            "conv3_dk": fwd["conv3"], "down_k2s2_bwd": fwd["down_k2s2"],
            "up_k2s2_bwd": fwd["up_k2s2"], "softmax_vjp": 1,
            "reparam_kl": int(sampled), "reparam_kl_vjp": int(sampled)}


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


def read_scores(work: str, prefix: str, epochs, name: str = "score"
                ) -> list:
    out = []
    for epoch in epochs:
        path = os.path.join(work, "tensorboard", prefix,
                            f"{name}_{epoch}.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
    return out


def saved_checkpoints(work: str, prefix: str) -> list:
    return [n for n in ("best_model.ckpt", "model_epoch1.ckpt",
                        "model_epoch2.ckpt")
            if os.path.exists(os.path.join(work, "3dmodel", prefix, n))]


# the libraries whose products run on the tensor cores
TENSOR_CORE_LIBS = ("conv3", "conv3_dk", "conv3_bwd", "bridge", "bridge_bwd")
# kernels (library, __global__ name) that must hold tensor-core
# instructions in their own functions: a library may have them from
# another of its kernels
TENSOR_CORE_KERNELS = (("bridge_bwd", "down_dx_kernel"),
                       ("bridge_bwd", "up_dx_kernel"))
# kernels (library, __global__ name) whose own functions must hold 128-bit
# global loads and stores: their items are 16 bytes
VECTOR_KERNELS = (("instance_norm", "norm_elementwise_kernel"),
                  ("losses", "softmax_vjp_c2_kernel"),
                  ("losses", "dice_sums_vec_kernel"),
                  ("losses", "dice_vjp_vec_kernel"))
# the VECTOR_KERNELS that store no item (a reduction writes its block
# partials): 128-bit loads only
LOAD_ONLY_KERNELS = ("dice_sums_vec_kernel",)
SASS_OPS = {"HMMA": r"\bHMMA\b", "HGMMA": r"\bHGMMA\b",
            "LDG.128": r"\bLDG(?:\.\w+)*\.128\b",
            "STG.128": r"\bSTG(?:\.\w+)*\.128\b"}


def sass_counts(sass: str) -> dict:
    """{"HMMA": n, "HGMMA": n, "LDG.128": n, "STG.128": n} in a piece of
    SASS: the tensor-core instructions and the 128-bit global loads and
    stores (any cache qualifiers)."""
    return {op: len(re.findall(pat, sass)) for op, pat in SASS_OPS.items()}


def tensor_core_sass(build):
    """{library: sass_counts}: the tensor-core instructions and 128-bit
    global accesses in each built library's SASS (``cuobjdump -sass``), and
    under "kernels" {"library/kernel": counts} summed over the functions
    (template instances) of each TENSOR_CORE_KERNELS and VECTOR_KERNELS
    entry; None where the toolkit has no cuobjdump (the caller fails the
    run then)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out, kernels = {}, {}
    for name in build.SIGNATURES:
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True).stdout
        out[name] = sass_counts(sass)
        for lib, kernel in TENSOR_CORE_KERNELS + VECTOR_KERNELS:
            if lib == name:
                kernels[f"{lib}/{kernel}"] = kernel_sass(sass, kernel)
    out["kernels"] = kernels
    return out


def kernel_sass(sass: str, kernel: str) -> dict:
    """sass_counts and {"functions": n} over the functions of the kernel
    `kernel` in `sass`: a function's SASS runs from its "Function :
    <mangled name>" line to the next one, and the mangled name holds
    <length><name>I (a template instance) or <length><name>E (a function
    of a namespace)."""
    parts = re.split(r"^\s*Function\s*:\s*(\S+)\s*$", sass, flags=re.M)
    out = {**{op: 0 for op in SASS_OPS}, "functions": 0}
    for fn, body in zip(parts[1::2], parts[2::2]):
        if re.search(rf"\d{kernel}[IE]", fn):
            out["functions"] += 1
            for op, n in sass_counts(body).items():
                out[op] += n
    return out


# ---- phase 14: test time (ft1 and the sliding-window sweep)

# the kernels of a finetune step and of a window chunk: phase 14 fails if
# its runs launch one of them no time
TEST_TIME_KERNELS = ("conv3", "down_k2s2", "up_k2s2", "conv3_dk",
                     "down_k2s2_bwd", "up_k2s2_bwd", "softmax_vjp",
                     "dice_sums", "dice_sums_vjp")

SW_PATCH, SW_BATCH, SW_OVERLAP, SW_SIZE, SW_CASES = (128, 128, 128), 4, 0.5, \
    160, 2


def test_time(torch, ops, run_cli, record_checked, model, image, label,
              work, data, manifest, args, log, failures) -> dict:
    """Phase 14: ft1 on the crop eval, one ft1 step's kernel calls and
    gates, the sliding-window sweep alone, post-processed and composed with
    ft1 (both route switches unset, as in phase 3). Returns the launches
    of its CLI runs."""
    import copy
    import dataclasses

    from vae_segmentation_tpu_torch.cli import target_main
    from vae_segmentation_tpu_torch.cli.common import (
        sweep_volume, volume_dice)
    from vae_segmentation_tpu_torch.core.config import parse_target_args
    from vae_segmentation_tpu_torch.data.pipeline import FullVolumeDataset
    from vae_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)
    from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
    from vae_segmentation_tpu_torch.eval.sliding_window import (
        sliding_window_predict, window_starts)
    t_phase = time.time()
    # the ft1 recipes' loss (scripts/target/domain_*_ft1.bash): dh type 8,
    # lambda 1, dropout 0
    base = ["--method", "domain_adaptation", "--test_only",
            "--load_prefix_joint", "smoke", "--save_root",
            os.path.join(work, "3dmodel"), "--domain_loss_type", "8",
            "--lambda_vae", "1.0", "--val_list", "NIH_val",
            "--patch_size", *map(str, SW_PATCH), "--device", "cuda"]
    dev = image.device
    fwd = {**{k: 0 for k in KERNEL_NAMES}, **PER_FORWARD}
    ft_step = expected_step_launches(model)
    seg_fwd = forward_launches(model.Seg)
    student0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    flags0 = {k: p_.requires_grad for k, p_ in model.named_parameters()}

    def student_unchanged() -> bool:
        return all(torch.equal(v, student0[k])
                   for k, v in model.state_dict().items()) and flags0 == {
            k: p_.requires_grad for k, p_ in model.named_parameters()}

    # ---- (a) ft1 on the crop eval: one finetune step and two Joint
    # forwards a case; score_noft_0 is phase 3's score_0, value for value
    _, a_s, a_launches = run_cli(target_main.main, [
        "smoke_ft1", *base, "--val_data_root", data, "--data_path",
        manifest, "--val_batch", "1", "--val_finetune", "1"])
    a_want = scaled(added(ft_step, scaled(fwd, 2)), args.cases)
    scores = (read_scores(work, "smoke_ft1", (0,)) or [{}])[0]
    noft = (read_scores(work, "smoke_ft1", (0,), "score_noft") or [{}])[0]
    plain = (read_scores(work, "smoke", (0,)) or [{}])[0]
    a_ok = (a_launches == a_want and noft == plain
            and all(len(sc) == args.cases
                    and all(0.0 <= v <= 1.0 for v in sc.values())
                    for sc in (scores, noft)))
    if not a_ok:
        failures.append(f"test_time_ft1: launches {a_launches} (want "
                        f"{a_want}), scores {scores}, score_noft {noft}, "
                        f"phase 3's {plain}")
    emit({"phase": "test_time_ft1", "cases": args.cases, "cli_s": a_s,
          "scores": scores, "scores_noft": noft, "main_path_scores": plain,
          "launches": a_launches, "launches_expected": a_want,
          "ok": a_ok}, log)

    # ---- (b) one ft1 step on case 0 at batch 1, through the CLI's
    # finetune: every kernel call against its plain version, then the loss
    # terms and the Seg update against the plain path's own drift
    ft_cfg = parse_target_args(["smoke_ft1_step", *base,
                                "--val_finetune", "1"])
    sched = target_main._epoch_sched(ft_cfg, 0, ft_cfg.lambda_vae)
    teacher = copy.deepcopy(model)
    for p_ in teacher.parameters():
        p_.requires_grad_(False)

    keys = ("recon_loss", "dice_loss_fake", "dice_loss", "final_loss")

    def ft1_step(lr=ft_cfg.lr_finetune):
        """(loss terms, Seg update, VAE unchanged) of one finetune from the
        student: at lr 0 the weights a recorded call holds stay the ones
        it ran with."""
        finetune, ft_model = target_main._make_finetune(
            dataclasses.replace(ft_cfg, lr_finetune=lr), 2, dev)
        aux = finetune(model, teacher, image[..., 0], label, sched)
        torch.cuda.synchronize()
        now = ft_model.state_dict()
        update = {k: (now[k] - student0[k]).float() for k in now
                  if k.startswith("Seg.")}
        vae_still = all(torch.equal(v, student0[k]) for k, v in now.items()
                        if k.startswith("Vae."))
        return {k: aux[k].item() for k in keys}, update, vae_still

    gate, gate_ok, ft_totals = gate_step(ops, record_checked, "ft1",
                                         ft1_step, ft_step)
    # what ft1 adds to a case: the copy, the freeze, the optimizer and one
    # step (host clock, synchronised)
    finetune = target_main._make_finetune(ft_cfg, 2, dev)[0]
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finetune(model, teacher, image[..., 0], label, sched)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    del finetune
    b_ok = (gate_ok and student_unchanged()
            and all(v == v and abs(v) != float("inf")
                    for v in gate["losses_kernels"].values()))
    if not b_ok:
        failures.append("test_time_ft1_step: the ft1 step with kernels "
                        "disagrees with the plain path, or it touched the "
                        "student or the VAE")
    emit({"phase": "test_time_ft1_step", "batch": 1,
          "lr": ft_cfg.lr_finetune, **gate,
          "student_unchanged": student_unchanged(),
          "step_ms": sorted(step_ms)[1], "step_ms_all": step_ms,
          "ok": b_ok}, log)
    del teacher
    torch.cuda.empty_cache()

    # ---- (c) the sliding window: 160^3 cases padded to 192^3, 8 windows
    # of 128^3 at overlap 0.5, 2 chunks at -b 4, cropped back to 160^3
    sw_data = os.path.join(work, "data_sw")
    sw_manifest = write_synthetic_dataset(sw_data, n_train=0,
                                          n_val=SW_CASES, size=SW_SIZE,
                                          seed=args.seed + 5)
    with open(sw_manifest) as f:
        sw_entries = json.load(f)["NIH_val"]
    cases = FullVolumeDataset(sw_entries, sw_data, parse_pan_index("1"))
    vols = [(sweep_volume(cases[i]["image"], SW_PATCH, dev),
             cases[i]["image"].shape) for i in range(len(cases))]
    windows = [len(window_starts(tuple(v.shape), SW_PATCH, SW_OVERLAP))
               for v, _ in vols]
    chunks = sum(-(-n_ // SW_BATCH) for n_ in windows)
    sweep_want = scaled(seg_fwd, chunks)
    runs = {}
    for name, extra, want in (
            ("smoke_sw", [], sweep_want),
            ("smoke_sw_pp", ["--postprocess", "--postprocess_min_voxels",
                             "100"], sweep_want),
            ("smoke_sw_ft1", ["--val_finetune", "1"],
             added(scaled(sweep_want, 2), scaled(ft_step, SW_CASES)))):
        _, secs, launches = run_cli(target_main.main, [
            name, *base, "--val_data_root", sw_data, "--data_path",
            sw_manifest, "--eval_mode", "sliding_window", "-b",
            str(SW_BATCH), "--sw_overlap", str(SW_OVERLAP), *extra])
        runs[name] = {
            "cli_s": secs, "launches": launches,
            "launches_expected": want,
            "scores": (read_scores(work, name, (0,)) or [{}])[0],
            "scores_noft": (read_scores(work, name, (0,), "score_noft")
                            or [{}])[0]}
    cli_ok = all(
        r["launches"] == r["launches_expected"]
        and len(r["scores"]) == SW_CASES
        and all(0.0 <= v <= 1.0 for v in r["scores"].values())
        for r in runs.values()) and \
        runs["smoke_sw_ft1"]["scores_noft"] == runs["smoke_sw"]["scores"]

    # every kernel call of one batch-4 window chunk, against its plain
    # version
    vol, shape = vols[0]
    starts = window_starts(tuple(vol.shape), SW_PATCH, SW_OVERLAP)
    p0, p1, p2 = SW_PATCH
    chunk = torch.stack([vol[z:z + p0, y:y + p1, x:x + p2]
                         for z, y, x in starts[:SW_BATCH].tolist()]
                        )[..., None].contiguous()

    def seg_chunk():
        with torch.no_grad():
            return model.segment(chunk)

    _, sw_totals, calls = record_checked(seg_chunk, seg_fwd,
                                         "sw_chunk_kernel", "window chunk",
                                         timed=False)
    del calls
    chunk_ms = cuda_ms(torch, seg_chunk)

    # case 0's stitched probabilities, kernel path against plain path
    def sweep():
        probs = sliding_window_predict(model.segment, vol, SW_PATCH,
                                       SW_OVERLAP, SW_BATCH, 2)
        torch.cuda.synchronize()
        return probs[:shape[0], :shape[1], :shape[2]]

    ops.reset_launch_counts()
    probs_k = sweep()
    sweep_launches = ops.launch_counts()
    sweep_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs_k2 = sweep()
        sweep_ms.append(1e3 * (time.perf_counter() - t0))
    with plain_ops():
        probs_p = sweep()
    with plain_ops(reordered=True):
        probs_r = sweep()
    drift = {"kernel_vs_plain": _mean_abs(probs_k, probs_p),
             "plain_vs_reordered": _mean_abs(probs_p, probs_r),
             "kernel_vs_kernel": _mean_abs(probs_k, probs_k2)}
    dice = [volume_dice(torch.argmax(p_, dim=-1), cases[0]["label"], 2)
            for p_ in (probs_k, probs_p)]
    finite = bool(torch.isfinite(probs_k).all())
    c0_chunks = -(-windows[0] // SW_BATCH)
    sweep_ok = (sweep_launches == scaled(seg_fwd, c0_chunks) and finite
                and tuple(probs_k.shape) == (*shape, 2)
                and abs(dice[0] - dice[1]) <= 0.01
                and drift["kernel_vs_plain"]
                <= DRIFT_MULTIPLE * drift["plain_vs_reordered"])
    del probs_k, probs_k2, probs_p, probs_r, chunk
    c_ok = cli_ok and sweep_ok
    if not c_ok:
        failures.append(f"test_time_sliding_window: CLI runs {runs}, the "
                        "sweep with kernels against the plain path "
                        f"{drift} {dice}, launches {sweep_launches}")
    cli_s = runs["smoke_sw"]["cli_s"]
    emit({"phase": "test_time_sliding_window", "cases": SW_CASES,
          "size": SW_SIZE, "padded": list(vol.shape), "patch": SW_PATCH,
          "batch": SW_BATCH, "overlap": SW_OVERLAP,
          "windows_per_case": windows, "chunks": chunks, "runs": runs,
          "cli_s_per_case": cli_s / SW_CASES,
          "sweep_ms": sorted(sweep_ms)[1], "sweep_ms_all": sweep_ms,
          "sweep_ms_per_chunk": sorted(sweep_ms)[1] / c0_chunks,
          "chunk_forward_ms": chunk_ms, "sweep_launches": sweep_launches,
          "mean_abs_drift": drift, "drift_multiple": DRIFT_MULTIPLE,
          "dice_kernels": dice[0], "dice_plain": dice[1], "finite": finite,
          "cli_ok": cli_ok, "sweep_ok": sweep_ok,
          "phase_14_s": time.time() - t_phase, "ok": c_ok}, log)
    del vols
    torch.cuda.empty_cache()
    return {"launches": added(a_launches,
                              *[r["launches"] for r in runs.values()]),
            "ft1_totals": ft_totals, "sw_totals": sw_totals}


# ---- phase 15: the runs that outlive one process and the last training
# flags (--resume, --pseudo_list, --aug_order 3, --aug_host)

# the kernels of phase 15's runs: those of the replay and adaptation steps
# and of vae_train (reparam_kl and its VJP); phase 15 fails if its runs
# launch one of them no time
LATER_FLAGS_KERNELS = TEST_TIME_KERNELS + ("reparam_kl", "reparam_kl_vjp")
# the cubic warp's f32 rule (tests/test_torch_augment_cubic.py::F32_TOL):
# the card's f32 warp within this fraction of the volume's largest |value|
# of the same draw warped on the CPU in f64
CUBIC_F32_TOL = 4e-6


def expected_replay_launches(seg) -> dict:
    """Kernel launches of one source-replay step (make_seg_replay_step),
    derived from the model: the SegUNet's forward and backward as a
    seg_train step launches them, plus one dice_sums and its VJP."""
    return {**expected_source_step_launches(seg, sampled=False),
            "dice_sums": 1, "dice_sums_vjp": 1}


def later_flags(torch, ops, run_cli, record_checked, model, batches, src,
                paths, args, log, failures) -> dict:
    """Phase 15 on the default route: (a) --resume of the vae_train and the
    target CLI, (b) the source replay (--pseudo_list): one replay step's
    kernel calls and gates, its timing alone and in an adaptation + replay
    iteration, the CLI, (c) the cubic warp at [4, 128^3] against its CPU run
    in f64 and its warp_ms beside order 1's, (d) a seg_train CLI with
    --aug_host and the host loader's time a batch. `src` is (images,
    labels) of the 4 source cases on the card (phase 8's), `paths` the work
    directory's data and list files. Returns the launches of its runs."""
    import contextlib
    import io

    from vae_segmentation_tpu_torch import train as T
    from vae_segmentation_tpu_torch.cli import common, source_main, target_main
    from vae_segmentation_tpu_torch.core.config import parse_source_args
    from vae_segmentation_tpu_torch.data import augment
    from vae_segmentation_tpu_torch.data.pipeline import intensity_normalize
    from vae_segmentation_tpu_torch.models import Joint, ShapeVAE
    t_phase = time.time()
    work = paths["work"]
    launches = {k: 0 for k in KERNEL_NAMES}
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    expected_step = expected_step_launches(model)
    replay_want = expected_replay_launches(model.Seg)
    evals = scaled({**{k: 0 for k in KERNEL_NAMES}, **PER_FORWARD},
                   args.cases)
    vae0 = ShapeVAE(n_class=2, dim=128, bottleneck=16384)
    vexpected = expected_source_step_launches(vae0, sampled=True)
    vfwd = forward_launches(vae0)
    del vae0
    common_argv = ["--save_root", os.path.join(work, "3dmodel"),
                   "--val_list", "NIH_val", "--val_data_root", paths["data"],
                   "--val_batch", "1", "--eval_epoch", "1", "--save_epoch",
                   "1", "--num_workers", "2", "--device", "cuda"]
    target_argv = ["--method", "domain_adaptation", "--load_prefix",
                   "smoke_seg", "--load_prefix_vae", "smoke_vae", "-b",
                   str(TRAIN_BATCH), "--domain_loss_type", "8",
                   "--lambda_vae", str(TRAIN_LAMBDA), "--lr_seg",
                   str(TRAIN_LR), "--vae_decoder_dropout", "0.5",
                   "--pseudo_save_epoch", "1", "--train_list", "NIH_train",
                   "--data_root", paths["train_data"], "--data_path",
                   paths["replay_lists"], *common_argv]
    vae_argv = ["--method", "vae_train", "-b", str(VAE_BATCH), "--lr_seg",
                str(VAE_LR), "--train_list", "NIH_train", "--data_root",
                paths["src_data"], "--data_path", paths["src_lists"],
                *common_argv]

    def cli(fn, argv, spy=None):
        """run_cli with stdout captured (and printed on), the checkpoint
        saves and loads timed, and `spy` = (module, name, wrapper) patched
        in; returns (best, seconds, launches, stdout, saves, loads)."""
        nonlocal launches
        saves, loads = [], []
        real_save, real_load = common.save_checkpoint, common.load_checkpoint

        def save(path, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_save(path, **kw)
            saves.append({"path": os.path.relpath(path, work),
                          "s": time.perf_counter() - t0,
                          "bytes": os.path.getsize(path)})

        def load(path):
            t0 = time.perf_counter()
            ck = real_load(path)
            loads.append({"path": os.path.relpath(path, work),
                          "s": time.perf_counter() - t0,
                          "bytes": os.path.getsize(path)})
            return ck

        out = io.StringIO()
        with ExitStack() as stack:
            stack.enter_context(mock.patch.object(common, "save_checkpoint",
                                                  save))
            stack.enter_context(mock.patch.object(common, "load_checkpoint",
                                                  load))
            if spy is not None:
                stack.enter_context(mock.patch.object(*spy))
            stack.enter_context(contextlib.redirect_stdout(out))
            best, secs, got = run_cli(fn, argv)
        sys.stdout.write(out.getvalue())
        launches = added(launches, got)
        return best, secs, got, out.getvalue(), saves, loads

    def steps_of(text):
        return sorted({int(m) for m in re.findall(r"^\[\s*(\d+),", text,
                                                  re.M)})

    # ---- (a) --resume: two outer epochs, then a third resumed from the
    # second's periodic checkpoint (params, epoch, best; the optimizer
    # fresh), the restored weights against the file bit for bit
    resume = {}
    for name, fn, argv, first_want, want, attr in (
            ("vae_train", source_main.main, vae_argv,
             added(scaled(vexpected, 2), scaled(vfwd, 2 * args.cases)),
             added(vexpected, scaled(vfwd, args.cases)), "load_network"),
            ("domain_adaptation", target_main.main, target_argv,
             added(scaled(expected_step, 2), scaled(evals, 2)),
             added(scaled(expected_step, 2), evals), "load_state")):
        prefix = f"smoke_resume_{name}"
        mod = source_main if fn is source_main.main else target_main
        argv = [prefix, *argv, "--max_epoch", "2"]
        best1, s1, got1, out1, saves1, _ = cli(fn, argv)
        restored = {}
        real = getattr(mod, attr)

        def spy_load(net, ck, *a, real=real):
            real(net, ck, *a)
            torch.cuda.synchronize()
            restored["match"] = all(
                torch.equal(v, ck["model_state_dict"][k].to(v.device))
                for k, v in net.state_dict().items()) and len(
                    net.state_dict()) == len(ck["model_state_dict"])
            restored["device"] = str(next(net.parameters()).device)

        argv2 = argv[:-1] + ["3", "--resume"]
        best2, s2, got2, out2, saves2, loads2 = cli(
            fn, argv2, (mod, attr, spy_load))
        latest = os.path.join(work, "3dmodel", prefix, "model_epoch2.ckpt")
        line = f"Resumed from {latest} at epoch 2 (best {best1:.4f})"
        ck3 = common.load_checkpoint(os.path.join(
            work, "3dmodel", prefix, "model_epoch3.ckpt"))
        ok = (line in out2 and steps_of(out2) == [3]
              and steps_of(out1) == ([1, 2] if name == "vae_train" else [2])
              and restored.get("match") is True
              and restored.get("device") == "cuda:0"
              and best2 >= best1
              and ck3["extra"] == {"best_result": best2}
              and got1 == first_want and got2 == want)
        if not ok:
            failures.append(f"resume_{name}: the resumed run did not "
                            f"restart at epoch 2 from its checkpoint "
                            f"({line!r} in its output: {line in out2}, "
                            f"steps {steps_of(out2)}, restored {restored}, "
                            f"launches {got2} want {want})")
        resume[name] = {
            "first_run_s": s1, "resumed_run_s": s2, "best_first": best1,
            "best_resumed": best2, "resume_line": line in out2,
            "steps_first": steps_of(out1), "steps_resumed": steps_of(out2),
            "restored_bitwise_on_card": restored.get("match"),
            "launches_first": got1, "launches_resumed": got2,
            "launches_expected": want, "saves": saves1 + saves2,
            "loads": loads2, "ok": ok}
    emit({"phase": "resume", "runs": resume,
          "ok": all(r["ok"] for r in resume.values())}, log)

    # ---- (b) the source replay: one step's kernel calls against their
    # plain versions (untimed, repeated bit for bit), its loss and Seg
    # update against the plain path's drift, its timing alone and in one
    # adaptation + replay iteration, then the CLI with --pseudo_list
    s_img, s_lab = src
    r_img = intensity_normalize(s_img[:TRAIN_BATCH]).contiguous()
    r_lab = s_lab[:TRAIN_BATCH].contiguous()
    replay_step = T.make_seg_replay_step(2)

    def fresh(lr):
        student = Joint(n_class=2, dim=128, bottleneck=16384,
                        vae_decoder_dropout=0.5).cuda()
        student.load_state_dict(state0)
        return student, T.optim.sgd(T.optim.freeze_vae(student), lr)

    def replay1(lr=TRAIN_LR):
        student, opt = fresh(lr)
        aux = replay_step(student, opt, r_img, r_lab)
        torch.cuda.synchronize()
        now = student.state_dict()
        update = {k: (now[k] - state0[k]).float() for k in now
                  if k.startswith("Seg.")}
        vae_still = all(torch.equal(v, state0[k]) for k, v in now.items()
                        if k.startswith("Vae."))
        return {"dice_loss": aux["dice_loss"].item()}, update, vae_still

    gate, gate_ok, replay_totals = gate_step(
        ops, record_checked, "replay", replay1, replay_want)
    torch.cuda.empty_cache()
    # timing: the replay step alone, then one adaptation + replay
    # iteration ('pseudo' variant, the teacher a copy of the student)
    student, opt = fresh(TRAIN_LR)
    run_r = timed_steps(torch, ops, lambda i: replay_step(student, opt,
                                                          r_img, r_lab))
    rec_r = {"phase": "replay_step_timing", "batch": TRAIN_BATCH,
             "step_ms": run_r["step_ms"], "step_ms_all": run_r["step_ms_all"],
             "enqueue_ms": run_r["enqueue_ms"],
             "launches_per_step": run_r["launches"],
             "peak_memory_bytes": run_r["peak_memory_bytes"]}
    emit(rec_r, log)
    profile_step(torch, lambda: replay_step(student, opt, r_img, r_lab),
                 run_r["step_ms"], "profile_replay_step", log, failures)
    teacher = Joint(n_class=2, dim=128, bottleneck=16384).cuda()
    teacher.load_state_dict(state0)
    for p_ in teacher.parameters():
        p_.requires_grad_(False)
    adapt = T.make_adapt_step(T.AdaptConfig(n_class=2, domain_loss_type=8),
                              variant="pseudo")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    sched = T.default_sched(TRAIN_LAMBDA)

    def iteration(i):
        aux = adapt(student, teacher, opt, *batches[i % 2], gen, sched)
        return {**aux, "dice_loss_pseudo": replay_step(
            student, opt, r_img, r_lab)["dice_loss"]}

    run_i = timed_steps(torch, ops, iteration)
    iter_want = added(expected_step, replay_want)
    rec_i = {"phase": "adapt_replay_iteration_timing", "batch": TRAIN_BATCH,
             "step_ms": run_i["step_ms"], "step_ms_all": run_i["step_ms_all"],
             "enqueue_ms": run_i["enqueue_ms"],
             "launches_per_iteration": run_i["launches"],
             "peak_memory_bytes": run_i["peak_memory_bytes"],
             "finite": run_i["finite"]}
    emit(rec_i, log)
    profile_step(torch, lambda: iteration(0), run_i["step_ms"],
                 "profile_adapt_replay_iteration", log, failures)
    timing_ok = (all(c == replay_want for c in run_r["launches"])
                 and all(c == iter_want for c in run_i["launches"])
                 and run_r["finite"] and run_i["finite"])
    del student, teacher, opt
    torch.cuda.empty_cache()
    # the CLI: two outer epochs (the first takes no step), 2 adaptation
    # steps and 2 replay steps in the second, with the device warp
    best, secs, got, out, _, _ = cli(target_main.main, [
        "smoke_replay", *target_argv, "--max_epoch", "2", "--pseudo_list",
        "SRC", "--pseudo_data_root", paths["src_data"]])
    cli_want = added(scaled(added(expected_step, replay_want), 2),
                     scaled(evals, 2))
    lines = re.findall(r"^\[\s*2,\s*\d+\] loss: (.*)$", out, re.M)
    cli_ok = (got == cli_want and len(lines) == 2
              and all(len(ln.split(", ")) == 4 for ln in lines)
              and 0.0 <= best <= 1.0)
    b_ok = gate_ok and timing_ok and cli_ok
    if not b_ok:
        failures.append(f"replay: gate {gate}, timing {timing_ok}, CLI "
                        f"{cli_ok} (launches {got} want {cli_want}, lines "
                        f"{lines})")
    emit({"phase": "replay", "batch": TRAIN_BATCH, **gate,
          "replay_step_ms": rec_r["step_ms"],
          "replay_enqueue_ms": rec_r["enqueue_ms"],
          "iteration_step_ms": rec_i["step_ms"],
          "iteration_enqueue_ms": rec_i["enqueue_ms"],
          "cli_s": secs, "cli_launches": got, "cli_launches_expected":
          cli_want, "cli_loss_lines": lines, "cli_best": best,
          "ok": b_ok}, log)

    # ---- (c) the cubic warp at [4, 128^3]: one draw on the card in f32
    # against the same sampling grid on the CPU in f64; warp_ms at order 3
    # and order 1
    patch = (128, 128, 128)
    wgen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    draw = augment.sample_affine_params(wgen, s_img.shape[0], patch,
                                        s_img.shape[1:])
    coords = augment.affine_coords(*draw, patch)
    img_k, lab_k = augment.warp_at(s_img, s_lab, coords, order=3)
    torch.cuda.synchronize()
    t0 = time.time()
    img_c, lab_c = augment.warp_at(s_img.double().cpu(),
                                   s_lab.double().cpu(),
                                   coords.double().cpu(), order=3)
    cpu_s = time.time() - t0
    scale = s_img.abs().max().item()
    cubic_err = (img_k.double().cpu() - img_c).abs().max().item()
    fill = augment.BORDER_CVAL_DATA
    mask_ok = torch.equal(img_k.cpu() == fill, img_c == fill)
    label_ok = torch.equal(lab_k.double().cpu(), lab_c)
    del img_k, lab_k, img_c, lab_c
    warp_ms = {}
    for o in (1, 3):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        warp_ms[o] = cuda_ms(torch, lambda o=o: augment.spatial_augment(
            s_img, s_lab, wgen, patch_size=patch, order=o),
            budget_ms=float("inf"), max_reps=5)
    peak3 = torch.cuda.max_memory_allocated()
    c_ok = cubic_err <= CUBIC_F32_TOL * scale and mask_ok and label_ok
    if not c_ok:
        failures.append(f"cubic warp: card vs CPU f64 max abs {cubic_err} "
                        f"(limit {CUBIC_F32_TOL * scale}), mask {mask_ok}, "
                        f"label {label_ok}")
    emit({"phase": "cubic_warp", "batch": int(s_img.shape[0]),
          "patch": patch, "max_abs_err_vs_cpu_f64": cubic_err,
          "limit": CUBIC_F32_TOL * scale, "rel_err": cubic_err / scale,
          "mask_equal": mask_ok, "label_equal": label_ok,
          "cpu_f64_s": cpu_s, "warp_ms_order3": warp_ms[3],
          "warp_ms_order1": warp_ms[1], "peak_memory_bytes_order3": peak3,
          "ok": c_ok}, log)

    # ---- (d) --aug_host: a seg_train CLI with the warp in the loader's
    # workers, and the host loader's time a batch at order 1 and 3
    host_argv = ["smoke_host", "--method", "seg_train", "-b", str(VAE_BATCH),
                 "--lr_seg", str(VAE_LR), "--train_list", "NIH_train",
                 "--data_root", paths["src_data"], "--data_path",
                 paths["src_lists"], *common_argv, "--max_epoch", "2",
                 "--aug_host"]
    seg_fwd = forward_launches(model.Seg)
    best, secs, got, _, _, _ = cli(source_main.main, host_argv)
    host_want = added(expected_source_step_launches(model.Seg,
                                                    sampled=False),
                      scaled(seg_fwd, 2 * args.cases))
    loader_ms = {}
    for order in (1, 3):
        cfg = parse_source_args(host_argv + ["--aug_order", str(order)])
        loader = common.build_train_loader(cfg, data_root=cfg.data_root,
                                           list_key=cfg.train_list)
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        loader_ms[order] = 1e3 * (time.perf_counter() - t0) / max(n, 1)
    d_ok = got == host_want and 0.0 <= best <= 1.0
    if not d_ok:
        failures.append(f"aug_host: seg_train launches {got} (want "
                        f"{host_want}), best {best}")
    emit({"phase": "aug_host", "cli_s": secs, "best_dice": best,
          "launches": got, "launches_expected": host_want,
          "loader_ms_per_batch_order1": loader_ms[1],
          "loader_ms_per_batch_order3": loader_ms[3],
          "batch": VAE_BATCH, "num_workers": 2,
          "phase_15_s": time.time() - t_phase, "ok": d_ok}, log)
    return {"launches": launches, "replay_totals": replay_totals}


# ---------------------------------------------------------------- phase 16:
# the host data layer: the native loader and resize against the numpy path
HOST_SIZE = 128
# the larger cases: a 256^3 volume whose ROI crop is about 180-211 a side
# (tests/test_native_loader.py:100's "typical crop -> patch" downscale)
LARGE_VOLUME, LARGE_EXTENTS = 256, (150, 176)
HOST_REPS = 3
RESIZE_RTOL, RESIZE_ATOL, NEAREST_MISMATCH = 2e-4, 2e-3, 1e-3


def large_phantoms(root: str, seed: int) -> list:
    """Cases of LARGE_VOLUME^3 (int16 merge.npy, the synthetic phantoms'
    intensities) with an ellipsoid label whose longest bbox extent is each
    of LARGE_EXTENTS, so that crop_resize's cube is L + 2 int(0.1 L) a
    side. Returns their manifest entries."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = LARGE_VOLUME
    zz, yy, xx = np.ogrid[0:n, 0:n, 0:n]
    entries = []
    for i, ext in enumerate(LARGE_EXTENTS):
        image = rng.normal(40.0, 30.0, (n, n, n)).astype(np.float32)
        image[:2] = -1000.0
        c = n // 2 + rng.integers(-8, 9, 3)
        radii = (ext / 2, 0.4 * ext, 0.35 * ext)
        inside = (((zz - c[0]) / radii[0]) ** 2 + ((yy - c[1]) / radii[1]) ** 2
                  + ((xx - c[2]) / radii[2]) ** 2) <= 1.0
        image[inside] += 60.0
        case = os.path.join(root, f"caselarge{i:04d}")
        os.makedirs(case, exist_ok=True)
        np.save(os.path.join(case, "merge.npy"),
                np.stack((image, inside), axis=-1).astype(np.int16))
        entries.append(f"caselarge{i:04d}/merge.npy")
    return entries


def cpu_model() -> str:
    """The host CPU's 'model name' and 'vendor_id' from /proc/cpuinfo (a
    virtual machine may say 'unknown' for the first)."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return f"{info.get('model name', 'unknown')} " \
        f"({info.get('vendor_id', 'unknown vendor')})"


def host_case(root: str, entry: str, failures: list) -> dict:
    """One case's host data, numpy path against native, HOST_REPS times in
    turns: ms of load + remap, bbox, and crop + resize to HOST_SIZE^3
    (median of the reps). The native image, label and bbox must equal the
    numpy path's; the native crop + resize must keep the resize rules
    (image within RESIZE_RTOL / RESIZE_ATOL, under NEAREST_MISMATCH of the
    label's voxels differing) and the same ori_shape."""
    import numpy as np

    from vae_segmentation_tpu_torch.data import native_loader, transforms

    path = os.path.join(root, entry)
    mask_index = transforms.parse_pan_index("1")
    size = (HOST_SIZE,) * 3
    ms = {k: [] for k in ("numpy_load", "numpy_bbox", "numpy_resize",
                          "native_load", "native_resize")}

    def numpy_path():
        t0 = time.perf_counter()
        case = transforms.load_merge_numpy(path, mask_index)
        t1 = time.perf_counter()
        bb = transforms.label_bbox(case["label"])
        box = np.concatenate(bb) if bb is not None else np.full(6, -1)
        t2 = time.perf_counter()
        with mock.patch.dict(os.environ, {"VAESEG_NATIVE_RESIZE": "0"}):
            out = transforms.crop_resize(case["image"], case["label"], size,
                                         bbox=box)
        t3 = time.perf_counter()
        ms["numpy_load"].append(1e3 * (t1 - t0))
        ms["numpy_bbox"].append(1e3 * (t2 - t1))
        ms["numpy_resize"].append(1e3 * (t3 - t2))
        return case, box, out

    def native_path():
        t0 = time.perf_counter()
        case = native_loader.load_case(path, mask_index)
        t1 = time.perf_counter()
        with mock.patch.dict(os.environ, {"VAESEG_NATIVE_RESIZE": "1"}):
            out = transforms.crop_resize(case["image"], case["label"], size,
                                         bbox=case["bbox"])
        t2 = time.perf_counter()
        ms["native_load"].append(1e3 * (t1 - t0))
        ms["native_resize"].append(1e3 * (t2 - t1))
        return case, case["bbox"], out

    for rep in range(HOST_REPS):
        turns = (numpy_path, native_path)[::1 if rep % 2 == 0 else -1]
        got = {fn: fn() for fn in turns}
    np_case, np_box, np_out = got[numpy_path]
    nat_case, nat_box, nat_out = got[native_path]
    same = {"image": bool(np.array_equal(nat_case["image"],
                                         np_case["image"])),
            "label": bool(np.array_equal(nat_case["label"],
                                         np_case["label"])),
            "bbox": bool(np.array_equal(nat_box, np_box))}
    img_err = np.abs(nat_out["image"] - np_out["image"])
    img_ok = bool(np.all(img_err <= RESIZE_ATOL
                         + RESIZE_RTOL * np.abs(np_out["image"])))
    mismatch = float(np.mean(nat_out["label"] != np_out["label"]))
    ok = (all(same.values()) and img_ok and mismatch < NEAREST_MISMATCH
          and np.array_equal(nat_out["ori_shape"], np_out["ori_shape"]))
    if not ok:
        failures.append(f"host data: {entry}: native against numpy "
                        f"{same}, resized image within the rule {img_ok}, "
                        f"label mismatch {mismatch}")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    return {"case": entry, "shape": list(np_case["image"].shape),
            "crop": [int(s) for s in np_out["ori_shape"][3:]],
            **{f"{k}_ms": v for k, v in med.items()},
            "numpy_total_ms": med["numpy_load"] + med["numpy_bbox"]
            + med["numpy_resize"],
            "native_total_ms": med["native_load"] + med["native_resize"],
            "equal": same, "resize_image_max_abs_err": float(img_err.max()),
            "resize_image_within_rule": img_ok,
            "resize_label_mismatch": mismatch, "ok": ok}


def host_data(run_cli, target_main, work, data, manifest, args, log,
              failures) -> None:
    """Phase 16: the host data layer. The loader's build (a fresh build into
    a scratch directory, timed, and how this process got its library), the
    host (CPU model, cores, VAESEG_LOADER_THREADS), every case of phase 3
    and two larger ones (host_case), then the eval CLI of phase 3 in turns
    on the numpy path and the native path (numpy, native, native, numpy):
    cli_s a case beside phase 3's; every run makes phase 3's launches, the
    native runs repeat phase 3's scores and the numpy runs each other's,
    and each case's Dice on the two paths is within 0.01 (phase 3's
    rule: the resized images differ within the resize rule)."""
    import numpy as np
    from pathlib import Path

    from vae_segmentation_tpu_torch.data import native_loader

    t_phase = time.time()
    scratch = os.path.join(work, "host_build")
    _, fresh = native_loader.build(Path(scratch))
    first_use = native_loader.build_record()
    emit({"phase": "host_build", "build_s": fresh["seconds"],
          "compiled": fresh["built"], "flags": list(native_loader.CXX_FLAGS),
          "cxx": os.environ.get("CXX") or "g++",
          "first_use": {k: first_use.get(k)
                        for k in ("path", "built", "seconds", "threads")},
          "cpu_model": cpu_model(), "cpu_count": os.cpu_count(),
          "loader_threads": native_loader.loader_threads()}, log)
    if not fresh["built"]:
        failures.append("host data: the scratch build did not compile")

    with open(manifest) as f:
        entries = json.load(f)["NIH_val"]
    large_root = os.path.join(work, "data_large")
    large = large_phantoms(large_root, args.seed + 16)
    sets = {"phase3_128": [host_case(data, e, failures) for e in entries],
            "large_256": [host_case(large_root, e, failures)
                          for e in large]}
    summary = {name: {k: float(np.mean([c[k] for c in cases]))
                      for k in cases[0] if k.endswith("_ms")}
               for name, cases in sets.items()}

    main_rec = next(r for r in log if r.get("phase") == "main_path")
    runs = []
    for i, route in enumerate(("numpy", "native", "native", "numpy")):
        prefix = f"smoke_host_{route}{i}"
        with ExitStack() as stack:
            if route == "numpy":
                stack.enter_context(mock.patch.dict(
                    os.environ, {"VAESEG_NATIVE_RESIZE": "0"}))
                stack.enter_context(mock.patch.object(
                    native_loader, "in_subset", return_value=False))
            _, secs, launches = run_cli(target_main.main, [
                prefix, "--method", "domain_adaptation", "--test_only",
                "--load_prefix_joint", "smoke", "--save_root",
                os.path.join(work, "3dmodel"), "--val_list", "NIH_val",
                "--val_data_root", data, "--data_path", manifest,
                "--val_batch", "1", "--device", "cuda"])
        scores = (read_scores(work, prefix, (0,)) or [{}])[0]
        repeat = main_rec["scores"] if route == "native" else \
            next((r["scores"] for r in runs if r["route"] == "numpy"),
                 scores)
        ok = (launches == main_rec["launches"]
              and len(scores) == args.cases and scores == repeat
              and all(abs(v - main_rec["scores"].get(k, -1.0)) <= 0.01
                      for k, v in scores.items()))
        if not ok:
            failures.append(f"host data: the eval CLI on the {route} path: "
                            f"launches {launches}, scores {scores} (phase "
                            f"3: {main_rec['launches']}, "
                            f"{main_rec['scores']})")
        runs.append({"route": route, "cli_s": secs,
                     "cli_s_per_case": secs / args.cases, "scores": scores,
                     "ok": ok})
    cli = {route: [r["cli_s_per_case"] for r in runs if r["route"] == route]
           for route in ("numpy", "native")}
    ok = all(c["ok"] for cases in sets.values() for c in cases) and \
        all(r["ok"] for r in runs)
    emit({"phase": "host_data", "output_size": HOST_SIZE, "reps": HOST_REPS,
          "cases": sets, "mean_ms": summary,
          "phase3_cli_s_per_case": main_rec["cli_s"] / args.cases,
          "eval_cli_runs": runs,
          "cli_s_per_case_numpy": cli["numpy"],
          "cli_s_per_case_native": cli["native"],
          "rules": {"rtol": RESIZE_RTOL, "atol": RESIZE_ATOL,
                    "nearest_mismatch": NEAREST_MISMATCH},
          "phase_16_s": time.time() - t_phase, "ok": ok}, log)


# ------------------------------------------------------------ phase 18: the
# serving outputs and observability (ROADMAP item 11b) and the Joint's
# source methods (item 11c)

# the kernels of phase 18's runs: phase 18 fails if its runs launch one of
# them no time
SERVING_KERNELS = TEST_TIME_KERNELS
# the primary device kernel of each forward wrapper (one a launch) in a
# profiler trace: the --profile_dir check
TRACE_KERNELS = {"conv3": r"\bconv3_kernel\b",
                 "down_k2s2": r"\bdown(?:_pre)?_kernel\b",
                 "up_k2s2": r"\bup_kernel\b"}


def expected_joint_step_launches(joint, teacher_joint: bool) -> dict:
    """Kernel launches of one source step of the Joint, derived from the
    model: the adaptation step's (``expected_step_launches``) less its
    teacher's Seg forward (joint_train, the cached pseudo label); with
    teacher_joint (sep_joint_train) plus the teacher Joint's forward and
    its Dice-sums pass (no VJP: no gradient)."""
    step = expected_step_launches(joint)
    seg = forward_launches(joint.Seg)
    out = {k: step[k] - seg[k] for k in KERNEL_NAMES}
    if teacher_joint:
        out = added(out, seg, forward_launches(joint.Vae))
        out["dice_sums"] += 1
    return out


def trace_kernels(path: str) -> dict:
    """Device kernel events of a torch.profiler Chrome trace: the count of
    each TRACE_KERNELS pattern and of each kernel family."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    fams = {}
    for n in names:
        fams[_family(n)] = fams.get(_family(n), 0) + 1
    return {"kernels": len(names),
            "primary": {k: sum(bool(re.search(p, n)) for n in names)
                        for k, p in TRACE_KERNELS.items()},
            "families": fams}


def tree_bytes(*dirs) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for top in dirs
               if os.path.isdir(top) for d, _, fs in os.walk(top)
               for f in fs)


def serving_and_methods(torch, ops, run_cli, record_checked, model, work,
                        data, manifest, train_data, lists, args, log,
                        failures) -> dict:
    """Phase 18 on the default route: (a) the eval CLI's serving outputs
    on phase 3's phantoms: --save_eval_result, --save_more_reference and
    --analysis_figure_name (where matplotlib imports) against a plain run
    (cli_s, bytes written; the dumps against phase 3's model, bit for
    bit), --profile_dir's trace against the run's launches, the analysis
    metrics on the card; (b) one step of each Joint source method at batch
    2: every kernel call against its plain version (untimed), the loss
    terms and the Seg update against the plain path's drift, the VAE
    unmoved, step_ms / enqueue_ms / peak memory; (c) the source CLI, one
    trained epoch of each method and its eval. Returns the launches of its
    CLI runs."""
    import contextlib
    import importlib.util
    import io
    import math

    import numpy as np

    from vae_segmentation_tpu_torch import train as T
    from vae_segmentation_tpu_torch.cli import source_main, target_main
    from vae_segmentation_tpu_torch.data.pipeline import (
        CaseDataset, intensity_normalize)
    from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
    from vae_segmentation_tpu_torch.eval.evaluate import (
        make_analysis_metrics_step)
    from vae_segmentation_tpu_torch.models import Joint
    from vae_segmentation_tpu_torch.ops import losses as L
    t_phase = time.time()
    launches = {k: 0 for k in KERNEL_NAMES}
    fwd = {**{k: 0 for k in KERNEL_NAMES}, **PER_FORWARD}
    packages = {p_: importlib.util.find_spec(p_) is not None
                for p_ in ("tensorboardX", "matplotlib")}

    def cli(fn, argv):
        """run_cli with stdout captured and printed on: (best, seconds,
        launches, stdout)."""
        nonlocal launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            best, secs, got = run_cli(fn, argv)
        print(out.getvalue(), end="")
        launches = added(launches, got)
        return best, secs, got, out.getvalue()

    # ---- (a) the serving outputs of the eval CLI
    base = ["--method", "domain_adaptation", "--test_only",
            "--load_prefix_joint", "smoke", "--save_root",
            os.path.join(work, "3dmodel"), "--val_list", "NIH_val",
            "--val_data_root", data, "--data_path", manifest,
            "--val_batch", "1", "--device", "cuda"]
    outputs = ["--save_eval_result", "--save_more_reference"]
    per_case = fwd
    if packages["matplotlib"]:
        outputs += ["--analysis_figure_name", "smoke_fig"]
        # the analysis: the student's Joint forward again, its VAE on the
        # one-hot label, the teacher's Joint forward
        per_case = added(scaled(fwd, 3), forward_launches(model.Vae))
    runs = {}
    for name, extra in (("plain", []), ("outputs", outputs),
                        ("outputs_again", outputs), ("plain_again", [])):
        prefix = "smoke_serve_" + name
        _, secs, got, _ = cli(target_main.main, [prefix, *base, *extra])
        runs[name] = {"cli_s": secs, "launches": got,
                      "scores": (read_scores(work, prefix, (0,))
                                 or [{}])[0]}
    prof = os.path.join(work, "prof")
    _, prof_s, prof_launches, _ = cli(target_main.main, [
        "smoke_serve_profiled", *base, "--profile_dir", prof])
    trace = trace_kernels(os.path.join(prof, "trace.json"))
    trace_ok = all(trace["primary"][k] == prof_launches[k]
                   for k in TRACE_KERNELS)
    out_dir = os.path.join(work, "result", "smoke_serve_outputs")
    written = tree_bytes(out_dir, os.path.join(work, "figure"),
                         os.path.join(work, "tensorboard",
                                      "smoke_serve_outputs"))
    with open(manifest) as f:
        entries = json.load(f)["NIH_val"]
    cases = CaseDataset(entries, data, parse_pan_index("1"))
    analysis = make_analysis_metrics_step(model, model, 2)
    dumps_ok, metrics = True, {}
    with torch.no_grad():
        for i in range(len(cases)):
            case = cases[i]
            img = intensity_normalize(
                torch.from_numpy(case["image"]).cuda())[None]
            lab = torch.from_numpy(case["label"]).cuda()[None]
            pred = model(img[..., None])[0]
            want = {"pred.join": L.binarize(pred).float()
                    .permute(0, 4, 1, 2, 3),
                    "pic": img[:, None],
                    "gt": L.one_hot_label(lab, 2, torch.float32)
                    .permute(0, 4, 1, 2, 3)}
            for stem, w in want.items():
                got = np.load(os.path.join(out_dir,
                                           f"0_{case['index']}_{stem}.npy"))
                dumps_ok = dumps_ok and got.dtype == np.float32 and \
                    np.array_equal(got, w.cpu().numpy())
            metrics[int(case["index"])] = {
                k: v.item() for k, v in analysis(img, lab).items()}
    metrics_ok = all(math.isfinite(v) and 0.0 <= v <= 1.0
                     for m in metrics.values() for v in m.values())
    figures = sorted(os.listdir(os.path.join(work, "figure",
                                             "analysis_figure"))) \
        if packages["matplotlib"] else []
    want_plain = scaled(fwd, args.cases)
    want_out = scaled(per_case, args.cases)
    a_ok = (dumps_ok and metrics_ok and trace_ok
            and all(r["launches"] == (want_out if "outputs" in n
                                      else want_plain)
                    for n, r in runs.items())
            and prof_launches == want_plain
            and all(r["scores"] == runs["plain"]["scores"]
                    for r in runs.values())
            and len(runs["plain"]["scores"]) == args.cases
            and (figures == ["analysis.jpg", "smoke_fig.jpg",
                             "smoke_fig_gt.jpg", "smoke_fig_pseudo.jpg"]
                 or not packages["matplotlib"]))
    if not a_ok:
        failures.append(f"serving outputs: dumps {dumps_ok}, metrics "
                        f"{metrics_ok}, trace {trace['primary']} against "
                        f"{prof_launches}, figures {figures}, runs "
                        f"{ {n: r['launches'] for n, r in runs.items()} }")
    emit({"phase": "serving_outputs", "cases": args.cases,
          "packages_importable": packages, "outputs_flags": outputs,
          "cli_s_plain": [runs["plain"]["cli_s"],
                          runs["plain_again"]["cli_s"]],
          "cli_s_outputs": [runs["outputs"]["cli_s"],
                            runs["outputs_again"]["cli_s"]],
          "cli_s_profiled": prof_s, "bytes_written": written,
          "launches_plain": runs["plain"]["launches"],
          "launches_outputs": runs["outputs"]["launches"],
          "launches_expected_outputs": want_out,
          "dumps_equal_phase3_bitwise": dumps_ok,
          "analysis_metrics": metrics, "analysis_metrics_ok": metrics_ok,
          "figures": figures, "trace": trace,
          "trace_launches": prof_launches, "trace_ok": trace_ok,
          "ok": a_ok}, log)

    # ---- (b) one step of each Joint source method at batch 2
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with open(lists) as f:
        train_entries = json.load(f)["NIH_train"]
    tds = CaseDataset(train_entries, train_data, parse_pan_index("1"))
    tcases = [tds[i] for i in range(TRAIN_BATCH)]
    img = intensity_normalize(torch.stack(
        [torch.from_numpy(c["image"]) for c in tcases]).cuda()).contiguous()
    lab = torch.stack([torch.from_numpy(c["label"])
                       for c in tcases]).cuda().contiguous()
    with torch.no_grad():
        pseudo = model(img[..., None])[0].float()
    sched = T.default_sched(TRAIN_LAMBDA)
    joint_step = T.make_joint_train_step(2)
    cached_step = T.make_cached_pseudo_adapt_step(T.AdaptConfig(n_class=2))
    sep_step = T.make_sep_joint_train_step(2)
    teacher = Joint(n_class=2, dim=128, bottleneck=16384).cuda()
    teacher.load_state_dict(state0)
    for p_ in teacher.parameters():
        p_.requires_grad_(False)
    methods = {
        "joint_train": (lambda st, opt: joint_step(st, opt, img, lab, sched),
                        expected_joint_step_launches(model, False)),
        "domain_adaptation": (lambda st, opt: cached_step(
            st, opt, img, lab, pseudo, sched),
            expected_joint_step_launches(model, False)),
        "sep_joint_train": (lambda st, opt: sep_step(st, teacher, opt, img),
                            expected_joint_step_launches(model, True)),
    }

    def fresh(lr):
        student = Joint(n_class=2, dim=128, bottleneck=16384).cuda()
        student.load_state_dict(state0)
        return student, T.optim.sgd(T.optim.freeze_vae(student), lr)

    def step1(run, lr):
        student, opt = fresh(lr)
        aux = run(student, opt)
        torch.cuda.synchronize()
        now = student.state_dict()
        update = {k: (now[k] - state0[k]).float() for k in now
                  if k.startswith("Seg.")}
        vae_still = all(torch.equal(v, state0[k]) for k, v in now.items()
                        if k.startswith("Vae."))
        return {k: v.item() for k, v in aux.items() if k != "pred"}, \
            update, vae_still

    b_recs, b_ok, totals = {}, True, {}
    for name, (run, want) in methods.items():
        gate, ok, totals[name] = gate_step(
            ops, record_checked, name,
            lambda lr=TRAIN_LR: step1(run, lr), want)
        torch.cuda.empty_cache()
        student, opt = fresh(TRAIN_LR)
        timing = timed_steps(torch, ops, lambda i: {
            k: v for k, v in run(student, opt).items() if k != "pred"})
        del student, opt
        torch.cuda.empty_cache()
        ok = (ok and timing["finite"]
              and all(c == want for c in timing["launches"]))
        b_ok = b_ok and ok
        b_recs[name] = {
            **gate, "step_ms": timing["step_ms"],
            "step_ms_all": timing["step_ms_all"],
            "enqueue_ms": timing["enqueue_ms"],
            "peak_memory_bytes": timing["peak_memory_bytes"], "ok": ok}
        if not ok:
            failures.append(f"{name} step: {b_recs[name]}")
    del teacher, pseudo
    torch.cuda.empty_cache()
    emit({"phase": "joint_source_steps", "batch": TRAIN_BATCH,
          "lr": TRAIN_LR, "steps": b_recs, "ok": b_ok}, log)

    # ---- (c) the source CLI: one trained epoch of each method (the cached
    # pseudo label: outer epoch 0 fills the cache, epoch 1 trains and
    # refreshes it, --mode 1), then its eval
    src_argv = ["--load_prefix_joint", "smoke", "--save_root",
                os.path.join(work, "3dmodel"), "--train_list", "NIH_train",
                "--val_list", "NIH_val", "--data_root", train_data,
                "--val_data_root", data, "--data_path", lists,
                "-b", str(TRAIN_BATCH), "--val_batch", "1",
                "--eval_epoch", "1", "--save_epoch", "1",
                "--num_workers", "2", "--lr_seg", str(TRAIN_LR),
                "--device", "cuda"]
    n_steps = len(train_entries) // TRAIN_BATCH
    evals = scaled(fwd, args.cases)
    c_recs, c_ok = {}, True
    for name, epochs, extra in (("joint_train", 1, []),
                                ("sep_joint_train", 1, []),
                                ("domain_adaptation", 2, ["--mode", "1"])):
        prefix = "smoke_src_" + name
        best, secs, got, out = cli(source_main.main, [
            prefix, "--method", name, "--max_epoch", str(epochs),
            *src_argv, *extra])
        want = added(scaled(methods[name][1], n_steps),
                     scaled(evals, epochs))
        if name == "domain_adaptation":   # the cache: the Seg forwards
            want = added(want, scaled(forward_launches(model.Seg), n_steps))
        lines = re.findall(r"^\[\s*\d+,\s*\d+\] loss: (.*)$", out, re.M)
        scores = read_scores(work, prefix, range(epochs))
        cache = sorted(os.listdir(os.path.join(
            work, "domain_cache", prefix))) \
            if name == "domain_adaptation" else []
        ok = (got == want and len(lines) == n_steps
              and len(scores) == epochs
              and all(len(sc) == args.cases
                      and all(0.0 <= v <= 1.0 for v in sc.values())
                      for sc in scores)
              and 0.0 <= best <= 1.0
              and (name != "domain_adaptation"
                   or cache == sorted(f"{i}_pred.npy"
                                      for i in range(len(train_entries)))))
        c_ok = c_ok and ok
        c_recs[name] = {"seconds": secs, "best_dice": best, "scores": scores,
                        "loss_lines": lines, "cache": cache,
                        "launches": got, "launches_expected": want,
                        "ok": ok}
    if not c_ok:
        failures.append(f"the source CLI's Joint methods: {c_recs}")
    emit({"phase": "joint_source_cli", "runs": c_recs, "ok": c_ok}, log)
    for name in SERVING_KERNELS:
        if launches[name] == 0:
            failures.append(f"{name} was never launched on the runs of "
                            "phase 18")
    emit({"phase": "serving_and_methods_seconds",
          "seconds": time.time() - t_phase}, log)
    return {"launches": launches, "step_totals": totals}


# ------------------------------------------------------------ phase 19: the
# Joint's last models and methods (ROADMAP items 11d, 11e, 11f, 11h): the
# soft-ReLU VAE, ShapeEncoder, Joint2, FusionNet, Embed

REMAINING_KERNELS = TEST_TIME_KERNELS + ("reparam_kl", "dice_sums",
                                         "dice_sums_vjp", "softmax_vjp")


def _convs_of(net, names) -> int:
    from vae_segmentation_tpu_torch.models.blocks import Conv3

    return sum(_count(getattr(net, n), Conv3) for n in names)


VAE_ENCODER = ("in_block", "down1", "down2", "down3", "down4", "down5")


def expected_encoder_step_launches(enc) -> dict:
    """Kernel launches of one discriminator_train step, derived from the
    model: the ShapeEncoder's forward, a dx conv for every conv but the
    entry (the mask needs no gradient), a weight gradient for every conv
    and bridge; the sigmoid head and the MSE are plain torch."""
    step = expected_source_step_launches(enc, False)
    return {**step, "softmax_vjp": 0}


def expected_adapt_dis_launches(joint2) -> dict:
    """Kernel launches of one domain_adaptation_dis step: the teacher
    SegUNet's forward, the student's Seg and Dis forwards, a dx conv for
    every conv of the Dis (its input, the prediction, takes the gradient
    into the Seg) and of the Seg but its entry, weight gradients for the
    Seg only (the Dis is frozen; its bridges' backwards skip dk and db),
    the Seg head's softmax VJP, one Dice-sums pass (2 targets) and its
    VJP."""
    seg, dis = forward_launches(joint2.Seg), forward_launches(joint2.Dis)
    return {**{k: 0 for k in KERNEL_NAMES},
            "conv3": 2 * seg["conv3"] + 2 * dis["conv3"] + seg["conv3"] - 1,
            "down_k2s2": 2 * seg["down_k2s2"] + dis["down_k2s2"],
            "up_k2s2": 2 * seg["up_k2s2"], "conv3_dk": seg["conv3"],
            "down_k2s2_bwd": seg["down_k2s2"] + dis["down_k2s2"],
            "up_k2s2_bwd": seg["up_k2s2"], "softmax_vjp": 1,
            "dice_sums": 1, "dice_sums_vjp": 1}


def embed_forward_launches(embed, dice: int = 0) -> dict:
    """Kernel launches of one test-mode Embed forward: the Encoder, the
    VAE of the ground truth (its latent drawn by one reparam_kl), the VAE
    decode of the Encoder's latent, the FusionNet and the VAE of the
    detached decode; `dice` Dice-sums passes."""
    enc, vae = forward_launches(embed.Encoder), forward_launches(embed.Vae)
    fus = forward_launches(embed.Fusion)
    dec = vae["conv3"] - _convs_of(embed.Vae, VAE_ENCODER)
    return {**{k: 0 for k in KERNEL_NAMES},
            "conv3": enc["conv3"] + 2 * vae["conv3"] + dec + fus["conv3"],
            "down_k2s2": enc["down_k2s2"] + 2 * vae["down_k2s2"]
            + fus["down_k2s2"],
            "up_k2s2": 3 * vae["up_k2s2"] + fus["up_k2s2"],
            "reparam_kl": 1, "dice_sums": dice}


def embed_segment_launches(embed) -> dict:
    """Kernel launches of ``Embed.segment``: the Encoder, the VAE decode
    of its latent, the FusionNet."""
    enc, vae = forward_launches(embed.Encoder), forward_launches(embed.Vae)
    fus = forward_launches(embed.Fusion)
    dec = vae["conv3"] - _convs_of(embed.Vae, VAE_ENCODER)
    return {**{k: 0 for k in KERNEL_NAMES},
            "conv3": enc["conv3"] + dec + fus["conv3"],
            "down_k2s2": enc["down_k2s2"] + fus["down_k2s2"],
            "up_k2s2": vae["up_k2s2"] + fus["up_k2s2"]}


def expected_embed_step_launches(embed, refine: bool) -> dict:
    """Kernel launches of one embed_train step (refine=False) or refine_vae
    step, derived from the model. embed_train's gradient reaches the
    Fusion (every conv but the image entry's takes a dx, every conv and
    bridge a weight gradient), the frozen VAE's decode of the Encoder's
    latent (dx only; its head's softmax VJP) and the Encoder (dx but the
    entry's, weight gradients); the pred and init_seg Dices take a VJP.
    refine_vae's reaches the VAE's decoder on its two passes that a loss
    reads (the ground truth's and the detached decode's: dx and weight
    gradients of every decoder conv and bridge, two head softmax VJPs) and
    nothing else; the recon and inpaint Dices take a VJP, the init_seg
    Dice (reported only) none."""
    fwd = embed_forward_launches(embed, 3 if refine else 4)
    enc, vae = forward_launches(embed.Encoder), forward_launches(embed.Vae)
    fus = forward_launches(embed.Fusion)
    dec = vae["conv3"] - _convs_of(embed.Vae, VAE_ENCODER)
    if refine:
        bwd = {"conv3": 2 * dec, "conv3_dk": 2 * dec,
               "up_k2s2_bwd": 2 * vae["up_k2s2"], "softmax_vjp": 2,
               "dice_sums_vjp": 2}
    else:
        bwd = {"conv3": fus["conv3"] - 1 + dec + enc["conv3"] - 1,
               "conv3_dk": fus["conv3"] + enc["conv3"],
               "down_k2s2_bwd": fus["down_k2s2"] + enc["down_k2s2"],
               "up_k2s2_bwd": fus["up_k2s2"] + vae["up_k2s2"],
               "softmax_vjp": 2, "dice_sums_vjp": 2}
    return {k: fwd[k] + bwd.get(k, 0) for k in KERNEL_NAMES}


def remaining_methods(torch, ops, run_cli, record_checked, work, data,
                      manifest, train_data, lists, args, log,
                      failures) -> dict:
    """Phase 19 on the default route (the soft step also on the norm
    route): (a) a soft-ReLU vae_train step at batch 4; (b) a
    discriminator_train step at batch 4 and a domain_adaptation_dis step
    at batch 2; (c) an embed_train step (enc_on 1) and a refine_vae step
    at batch 2; each from seeded full-width weights on phase 5's train
    cases, held by ``gate_step`` (the default route's steps with a reparam
    KL over phase 9's four plain orders); ``step_ms``, ``enqueue_ms``, peak memory of 3
    steps and the profiler's device time; (d) each method through its CLI
    at 128^3 (target vae_train --softrelu 1, discriminator_train,
    domain_adaptation_dis; source embed_train with the crop and the
    sliding-window eval, refine_vae from a seeded Embed checkpoint):
    launches derived from the model, a loss line a step, scores in [0, 1],
    checkpoints. Returns the launches of its runs."""
    import contextlib
    import io

    from vae_segmentation_tpu_torch import train as T
    from vae_segmentation_tpu_torch.cli import source_main, target_main
    from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
    from vae_segmentation_tpu_torch.data.pipeline import (
        CaseDataset, intensity_normalize)
    from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
    from vae_segmentation_tpu_torch.models import (
        Embed, Joint2, SegUNet, ShapeEncoder, ShapeVAE)
    t_phase = time.time()
    launches = {k: 0 for k in KERNEL_NAMES}

    with open(lists) as f:
        train_entries = json.load(f)["NIH_train"]
    tds = CaseDataset(train_entries, train_data, parse_pan_index("1"))
    tcases = [tds[i] for i in range(VAE_BATCH)]
    img4 = intensity_normalize(torch.stack(
        [torch.from_numpy(c["image"]) for c in tcases]).cuda()).contiguous()
    lab4 = torch.stack([torch.from_numpy(c["label"])
                        for c in tcases]).cuda().contiguous()
    img2, lab2 = img4[:TRAIN_BATCH], lab4[:TRAIN_BATCH]
    seed = torch.Generator().manual_seed(args.seed + 19)

    def build(cls, **kw):
        return cls(generator=seed, **kw).cuda()

    nets = {"vae": build(ShapeVAE, soft=True),
            "enc": build(ShapeEncoder, dim=1),
            "joint2": build(Joint2), "embed": build(Embed)}
    teacher = build(SegUNet)
    for p_ in teacher.parameters():
        p_.requires_grad_(False)
    states = {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
              for n, m in nets.items()}
    target = torch.linspace(0.2, 1.0, VAE_BATCH, device="cuda")
    sched = T.default_sched(TRAIN_LAMBDA)
    vae_step = T.make_vae_train_step(2, scale=VAE_SCALE)
    disc_step = T.make_discriminator_step()
    dis_step = T.make_adapt_dis_step(T.AdaptConfig(n_class=2))
    embed_step = T.make_embed_train_step(2)
    refine_step = T.make_refine_vae_step(2)
    # name: (network, trainable parameters, run(model, opt, gen), expected
    # launches, frozen prefixes, lr, the route's switches)
    steps = {
        "soft_vae_train": (
            "vae", lambda m: m.parameters(),
            lambda m, o, g: vae_step(m, o, lab4, g),
            expected_source_step_launches(nets["vae"], True), (), VAE_LR,
            ()),
        "soft_vae_train_norm_route": (
            "vae", lambda m: m.parameters(),
            lambda m, o, g: vae_step(m, o, lab4, g),
            expected_norm_source_step_launches(nets["vae"], True), (),
            VAE_LR, ("VAESEG_PALLAS",)),
        "discriminator_train": (
            "enc", lambda m: m.parameters(),
            lambda m, o, g: disc_step(m, o, lab4, target),
            expected_encoder_step_launches(nets["enc"]), (), TRAIN_LR,
            ()),
        "domain_adaptation_dis": (
            "joint2", T.optim.freeze_dis,
            lambda m, o, g: dis_step(m, teacher, o, img2, lab2, g, sched),
            expected_adapt_dis_launches(nets["joint2"]), ("Dis.",),
            TRAIN_LR, ()),
        "embed_train": (
            "embed", T.optim.freeze_vae,
            lambda m, o, g: embed_step(m, o, img2, lab2, g, 1.0),
            expected_embed_step_launches(nets["embed"], False), ("Vae.",),
            TRAIN_LR, ()),
        "refine_vae": (
            "embed", T.optim.freeze_vae_encoder,
            lambda m, o, g: refine_step(m, o, img2, lab2, g),
            expected_embed_step_launches(nets["embed"], True),
            tuple(f"Vae.{n}." for n in VAE_ENCODER + ("fc_mean", "fc_std"))
            + ("Encoder.", "Fusion."), TRAIN_LR, ()),
    }

    def fresh(net, trainable, lr):
        model = nets[net]
        model.load_state_dict(states[net])
        for p_ in model.parameters():
            p_.requires_grad_(True)
        return model, T.optim.sgd(trainable(model), lr)

    def step1(name, lr):
        net, trainable, run, _, frozen, _, _ = steps[name]
        model, opt = fresh(net, trainable, lr)
        aux = run(model, opt, torch.Generator(device="cuda").manual_seed(
            args.seed))
        torch.cuda.synchronize()
        now = model.state_dict()
        update = {k: (now[k] - states[net][k]).float() for k in now
                  if not k.startswith(frozen) and now[k].is_floating_point()}
        still = all(torch.equal(v, states[net][k]) for k, v in now.items()
                    if k.startswith(frozen))
        return {k: v.item() for k, v in aux.items() if v.dim() == 0}, \
            update, still

    recs, ok_all, totals = {}, True, {}
    for name, (net, trainable, run, want, frozen, lr, switches) in \
            steps.items():
        with route(*switches):
            gate, ok, totals[name] = gate_step(
                ops, record_checked, name,
                lambda lr=lr: step1(name, lr), want,
                # the shuffle reorders K1's stats, which the norm route
                # does not take
                shuffled=net in ("vae", "embed") and not switches)
            torch.cuda.empty_cache()
            model, opt = fresh(net, trainable, lr)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            timing = timed_steps(torch, ops, lambda i: {
                k: v for k, v in run(model, opt, gen).items()
                if v.dim() == 0})
            profile_step(torch, lambda: run(model, opt, gen),
                         timing["step_ms"], f"{name}_step_profile", log,
                         failures)
            del model, opt
            torch.cuda.empty_cache()
        ok = (ok and timing["finite"]
              and all(c == want for c in timing["launches"]))
        ok_all = ok_all and ok
        recs[name] = {
            **gate, "step_ms": timing["step_ms"],
            "step_ms_all": timing["step_ms_all"],
            "enqueue_ms": timing["enqueue_ms"],
            "peak_memory_bytes": timing["peak_memory_bytes"], "ok": ok}
        if not ok:
            failures.append(f"{name} step: {recs[name]}")
    del nets, teacher, states
    torch.cuda.empty_cache()
    emit({"phase": "remaining_steps", "steps": recs, "ok": ok_all}, log)

    # ---- (d) the CLIs: each method at 128^3, one trained epoch (two outer
    # epochs for domain_adaptation_dis: it takes no step in the first)
    def cli(fn, argv):
        nonlocal launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            best, secs, got = run_cli(fn, argv)
        print(out.getvalue(), end="")
        launches = added(launches, got)
        return best, secs, got, out.getvalue()

    save_root = os.path.join(work, "3dmodel")
    for name, m in (("smoke19_enc", ShapeEncoder(dim=1)),
                    ("smoke19_seg", SegUNet()), ("smoke19_embed", Embed())):
        save_checkpoint(os.path.join(save_root, name, "best_model.ckpt"),
                        epoch=0, model=m)
    argv = ["--save_root", save_root, "--train_list", "NIH_train",
            "--val_list", "NIH_val", "--data_root", train_data,
            "--val_data_root", data, "--data_path", lists,
            "-b", str(TRAIN_BATCH), "--val_batch", "1", "--eval_epoch", "1",
            "--save_epoch", "1", "--num_workers", "2", "--lr_seg",
            str(TRAIN_LR), "--device", "cuda"]
    n_steps = len(train_entries) // TRAIN_BATCH
    vae, enc = ShapeVAE(soft=True), ShapeEncoder(dim=1)
    joint2, embed = Joint2(), Embed()
    vae_step_n = expected_source_step_launches(vae, True)
    # the crop eval's and the sliding window's forward: Embed.segment
    emb_eval = embed_segment_launches(embed)
    runs = {
        "smoke19_tv": (target_main.main, [
            "--method", "vae_train", "--softrelu", "1", "--max_epoch", "1",
            "--lr_seg", str(VAE_LR)], 1,
            added(scaled(vae_step_n, n_steps),
                  scaled(forward_launches(vae), args.cases)), 2),
        "smoke19_dt": (target_main.main, [
            "--method", "discriminator_train", "--max_epoch", "1"], 1,
            added(scaled(expected_encoder_step_launches(enc), n_steps),
                  scaled(forward_launches(enc), args.cases)), 1),
        "smoke19_dd": (target_main.main, [
            "--method", "domain_adaptation_dis", "--max_epoch", "2",
            "--load_prefix", "smoke19_seg", "--load_prefix_encoder",
            "smoke19_enc", "--lambda_vae", str(TRAIN_LAMBDA)], 2,
            added(scaled(expected_adapt_dis_launches(joint2), n_steps),
                  scaled(forward_launches(joint2.Seg), 2 * args.cases)), 3),
        "smoke19_em": (source_main.main, [
            "--method", "embed_train", "--max_epoch", "1"], 1,
            added(scaled(expected_embed_step_launches(embed, False),
                         n_steps), scaled(emb_eval, args.cases)), 5),
        "smoke19_emsw": (source_main.main, [
            "--method", "embed_train", "--max_epoch", "1", "--eval_mode",
            "sliding_window"], 1,
            added(scaled(expected_embed_step_launches(embed, False),
                         n_steps),
                  scaled(emb_eval, args.cases)), 5),
        "smoke19_rv": (source_main.main, [
            "--method", "refine_vae", "--max_epoch", "1",
            "--load_prefix_joint", "smoke19_embed"], 1,
            added(scaled(expected_embed_step_launches(embed, True),
                         n_steps), scaled(emb_eval, args.cases)), 3),
    }
    del vae, enc, joint2, embed
    c_recs, c_ok = {}, True
    for prefix, (fn, extra, epochs, want, terms) in runs.items():
        best, secs, got, out = cli(fn, [prefix, *extra, *argv])
        lines = re.findall(r"^\[\s*\d+,\s*\d+\] loss: (.*)$", out, re.M)
        scores = read_scores(work, prefix, range(epochs))
        ok = (got == want and len(lines) == n_steps
              and all(len(ln.split(", ")) == terms for ln in lines)
              and len(scores) == epochs
              and all(len(sc) == args.cases
                      and all(0.0 <= v <= 1.0 for v in sc.values())
                      for sc in scores)
              and 0.0 <= best <= 1.0
              and len(saved_checkpoints(work, prefix)) >= 2)
        c_ok = c_ok and ok
        c_recs[prefix] = {"seconds": secs, "best": best, "scores": scores,
                          "loss_lines": lines, "launches": got,
                          "launches_expected": want, "ok": ok}
    if not c_ok:
        failures.append(f"the CLIs' remaining methods: {c_recs}")
    emit({"phase": "remaining_cli", "runs": c_recs, "ok": c_ok}, log)
    for name in REMAINING_KERNELS:
        if launches[name] == 0:
            failures.append(f"{name} was never launched on the CLI runs of "
                            "phase 19")
    emit({"phase": "remaining_methods_seconds",
          "seconds": time.time() - t_phase}, log)
    return {"launches": launches, "step_totals": totals}


# ------------------------------------------------------------ phase 20: the
# library-only models (ROADMAP item 11g): norm types 2 (BatchNorm) and 3
# (GSNorm) and the GS family of models/gs.py

LIBRARY_KERNELS = ("conv3", "down_k2s2", "up_k2s2", "conv3_dk",
                   "down_k2s2_bwd", "up_k2s2_bwd", "softmax_vjp",
                   "reparam_kl", "reparam_kl_vjp")
# condition_gsnorm: the bound's share that a 3^3 kernel's output channels
# share (P); the biases' share
GS_COMMON, GS_BIAS = 0.1, 0.01


def condition_gsnorm(torch, model, gen) -> None:
    """Redraw `model`'s weights in place from `gen` so that a norm_type 3
    pass is well conditioned. A GSNorm divides a conv output by its channel
    sum + 1e-4; on the default draw those sums come near 0, a forward
    drifts from itself by 1.0 max / 0.34 mean abs when only its f32
    summation order changes, and a vae_train step's gradients reach 1e34
    (CPU, 64^3, full width). Here each 3^3 kernel is V - mean_O(V) + P,
    V ~ U(-b, b) and P ~ U(0, GS_COMMON b) shared by its output channels
    (b = 1 / sqrt(fan_in)): the channels differ by signed weights, and
    their sum, the GSNorm's denominator, is C_out P . x, never negative on
    the non-negative inputs that a ReLU, a softmax or a one-hot mask gives.
    The bridges and dense layers are U(0, b), every bias U(0, GS_BIAS b)."""
    import math

    from vae_segmentation_tpu_torch.models.blocks import (
        Conv3, DownConv, TConv2)

    def draw(shape, lo, hi):
        return torch.empty(shape).uniform_(lo, hi, generator=gen)

    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, (Conv3, DownConv, TConv2, torch.nn.Linear)):
                continue
            b = 1.0 / math.sqrt(m.weight[0].numel())
            if isinstance(m, Conv3):
                v = draw(m.weight.shape, -b, b)
                p = draw((1, *m.weight.shape[1:]), 0.0, GS_COMMON * b)
                m.weight.copy_(v - v.mean(dim=0, keepdim=True) + p)
            else:
                m.weight.copy_(draw(m.weight.shape, 0.0, b))
            m.bias.copy_(draw(m.bias.shape, 0.0, GS_BIAS * b))


def k1_y_checks(torch, calls, plant: bool = False) -> dict:
    """Phase 20: every recorded K1 call with no prologue and no epilogue
    (the norm_type 2 / 3 and GS convs, forward and dx) held by the first
    part of K1's stored-y rule too (``k1_y_rule``): each element within one
    bf16 ulp of the f64 conv beyond the f32 sum's own error. That bound is
    tighter than ``compare_call``'s 1e-2 of max|y|, which a uniform 1%
    error would meet at its limit; with `plant`, the first call's kernel
    output times 1.01 (a planted 1% fault) must fail it. The flips (the
    distinct values off the once-rounded one) are reported beside the
    plain version's, not gated: on the conditioned draw's cancelling sums
    K1's truncating MMA accumulation flipped 3.7x the plain version's
    values in one call with every element inside the bound. Returns the
    calls checked, the worst counts, the plant's result and ok."""
    from vae_segmentation_tpu_torch.ops import conv3

    rec = {"calls": 0, "y_beyond_ulp": 0, "worst_flips": 0,
           "worst_flip_ratio": 0.0, "calls_over_twice_plain_flips": 0,
           "ok": True}
    for c in calls:
        a = c["args"]
        if c["kernel"] != "conv3" or a.get("pre") is not None \
                or a.get("stats") or a.get("softmax") \
                or a.get("post") is not None:
            continue
        with torch.no_grad():
            y = conv3.conv3_op(**a)
            ref, mag = k1_reference(torch, a["x"], a["weight"], a["bias"],
                                    None)
            far, _, flips = k1_y_rule(torch, y, ref, mag)
            flips_p = k1_y_rule(torch, c["out"], ref, mag)[2]
            if plant and rec["calls"] == 0:
                bad = (y.float() * 1.01).to(y.dtype)
                far_f, _, flips_f = k1_y_rule(torch, bad, ref, mag)
                rec["planted_fault"] = {
                    "shape": list(a["x"].shape), "y_beyond_ulp": far_f,
                    "flips": flips_f,
                    "max_rule_passes": (bad.float() - c["out"].float())
                    .abs().max().item()
                    <= 1e-2 * c["out"].float().abs().max().item(),
                    "fails": far_f > 0}
                rec["ok"] = rec["ok"] and far_f > 0
            del ref, mag
        rec["calls"] += 1
        rec["y_beyond_ulp"] += far
        rec["worst_flips"] = max(rec["worst_flips"], flips)
        rec["worst_flip_ratio"] = max(rec["worst_flip_ratio"],
                                      flips / max(flips_p, K1_FLIP_FLOOR))
        rec["calls_over_twice_plain_flips"] += \
            flips > max(2 * flips_p, K1_FLIP_FLOOR)
        rec["ok"] = rec["ok"] and far == 0
    rec["ok"] = rec["ok"] and rec["calls"] > 0
    return rec


def running_buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def library_models(torch, ops, record_checked, image, train_data, lists,
                   args, log, failures) -> dict:
    """Phase 20 on the default route, full width (fmaps 8-256, 128^3),
    seeded weights: (a) norm_type 3: a Joint eval forward (batch 1) on
    phase 3's phantom, on the default draw and on the conditioned draw
    (``condition_gsnorm``), and a vae_train step (batch 4) on phase 5's
    train cases on the conditioned draw; (b) a norm_type 2 SegUNet forward
    at batch 2 on phase 5's train images; (c) a SegmentationGS forward at
    batch 1 on phase 3's phantom, then GSConv3d (3^3 and 2^3 stride 2),
    SConv3d and GSConvTranspose3d (2^3 stride 2) once each. Every kernel
    call of each pass against its plain version, untimed and repeated bit
    for bit, each K1 call also by its stored-y bound (``k1_y_checks``; a
    planted 1% fault in one must fail it): the authority; launches derived
    from the model. Whole-pass
    rules (``forward_part``): finite outputs, probabilities summing to 1,
    the kernel path repeating its bits, and, but on the default norm_type 3
    draw (chaotic: reported only), the mean abs difference from the plain
    path within DRIFT_MULTIPLE times the plain path's own reordered drift;
    (b)'s running buffers each within F32_TOL of their largest element or
    DRIFT_MULTIPLE times the reordered drift; the step by ``gate_step`` on
    its gradients (the conditioned net's fall ~10x a layer from the head:
    below SGD's resolution of the deep weights on every path).
    ``forward_ms`` / ``step_ms``, peak memory and the profiler's device
    time of each. Returns the launches of its checked kernel-path passes
    and the per-call totals."""
    from vae_segmentation_tpu_torch import train as T
    from vae_segmentation_tpu_torch.data.pipeline import (
        CaseDataset, intensity_normalize)
    from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
    from vae_segmentation_tpu_torch.models import (
        GSConv3d, GSConvTranspose3d, Joint, SConv3d, SegmentationGS,
        SegUNet, ShapeVAE)
    t_phase = time.time()
    launches = {k: 0 for k in KERNEL_NAMES}
    totals, recs = {}, {}

    with open(lists) as f:
        train_entries = json.load(f)["NIH_train"]
    tds = CaseDataset(train_entries, train_data, parse_pan_index("1"))
    tcases = [tds[i] for i in range(VAE_BATCH)]
    img2 = intensity_normalize(torch.stack(
        [torch.from_numpy(c["image"]) for c in tcases[:TRAIN_BATCH]]
    ).cuda())[..., None].contiguous()
    lab4 = torch.stack([torch.from_numpy(c["label"])
                        for c in tcases]).cuda().contiguous()
    # the conditioned draw wants a non-negative image: [-1, 1] -> [0, 1]
    image01 = ((image + 1.0) / 2.0).contiguous()

    def seeded(k):
        return torch.Generator().manual_seed(args.seed + 20 + k)

    def forward_part(name, model, x, probs, drift_gate=True, plant=False):
        """One forward of `model` on x: every kernel call recorded on the
        plain path and held to its plain version (record_checked,
        untimed); the kernel path's launches (derived from the model),
        finite outputs on both paths, the probability outputs `probs`
        summing to 1 within 1e-2 (bf16), a second kernel-path forward
        equal bit for bit, each output's mean abs difference from the plain
        path beside the plain path's reordered drift (gated for `probs`
        with `drift_gate`: phase 3's rule), running buffers likewise,
        forward_ms, peak memory and a profile. Each pass starts from the
        same weights and buffers."""
        nonlocal launches
        state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}

        def run():
            model.load_state_dict(state0)
            with torch.no_grad():
                out = model(x)
            return [o for o in (out if isinstance(out, tuple) else (out,))], \
                running_buffers(model)

        want = forward_launches(model)
        (out_p, buf_p), totals[name], calls = record_checked(
            run, want, f"{name}_kernel", f"{name} forward", timed=False)
        y_rule = k1_y_checks(torch, calls, plant=plant)
        del calls
        ops.reset_launch_counts()
        out_k, buf_k = run()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        launches = added(launches, got)
        out_k2, _ = run()
        with plain_ops(reordered=True):
            out_r, buf_r = run()
        drift = [{"kernel_vs_plain": _mean_abs(k_, p_),
                  "plain_vs_reordered": _mean_abs(p_, r_),
                  "max_kernel_vs_plain": (k_.float() - p_.float()).abs()
                  .max().item()}
                 for k_, p_, r_ in zip(out_k, out_p, out_r)]
        finite = all(bool(torch.isfinite(o.float()).all())
                     for o in out_k + out_p)
        sum_err = max(((out_k[i].float().sum(-1) - 1.0).abs().max().item()
                       for i in probs), default=0.0)
        repeat = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
        buffers = {}
        for k in buf_p:
            err = (buf_k[k] - buf_p[k]).abs().max().item()
            own = (buf_r[k] - buf_p[k]).abs().max().item()
            top = buf_p[k].abs().max().item()
            buffers[k] = {"err": err, "reordered_drift": own, "max": top,
                          "ok": err <= max(F32_TOL * top,
                                           DRIFT_MULTIPLE * own)}
        drift_ok = all(drift[i]["kernel_vs_plain"]
                       <= DRIFT_MULTIPLE * drift[i]["plain_vs_reordered"]
                       for i in probs)
        ok = (got == want and finite and sum_err <= 1e-2 and repeat
              and y_rule["ok"] and (drift_ok or not drift_gate)
              and all(b_["ok"] for b_ in buffers.values()))
        del out_k, out_k2, out_p, out_r, buf_k, buf_p, buf_r
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fms = forward_ms(torch, model, x, reps=3)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_forward(torch, model, x, failures, reps=3,
                               phase=f"{name}_profile")
        emit(prof, log)
        model.load_state_dict(state0)
        rec = {"phase": name, "shape": list(x.shape),
               "launches": got, "launches_expected": want,
               "k1_y_rule": y_rule, "finite": finite,
               "prob_sum_err": sum_err,
               "repeat_bitwise": repeat, "mean_abs_drift": drift,
               "drift_gated": drift_gate, "drift_ok": drift_ok,
               "drift_multiple": DRIFT_MULTIPLE,
               "running_buffers": len(buffers),
               "buffers_worst": max(buffers.values(),
                                    key=lambda b_: b_["err"],
                                    default=None),
               "forward_ms": fms, "peak_memory_bytes": peak,
               "device_ms": prof["device_ms"],
               "busy_share": prof["busy_share"], "ok": ok}
        emit(rec, log)
        if not ok:
            failures.append(f"{name}: {rec}")
        recs[name] = rec
        return rec

    # ---- (a) norm_type 3: the Joint forward on the default draw (every
    # call's rule; the whole pass is chaotic) and on the conditioned draw
    joint = Joint(n_class=2, dim=128, bottleneck=16384, generator=seeded(0),
                  norm_type=3).cuda().eval()
    forward_part("library_joint3_default", joint, image, (0, 1),
                 drift_gate=False)
    condition_gsnorm(torch, joint, seeded(1))
    forward_part("library_joint3", joint, image01, (0, 1), plant=True)
    del joint
    torch.cuda.empty_cache()

    # the norm_type 3 vae_train step on the conditioned draw
    vae = ShapeVAE(n_class=2, dim=128, bottleneck=16384,
                   generator=seeded(2), norm_type=3).cuda()
    condition_gsnorm(torch, vae, seeded(3))
    vstate = {k: v.detach().clone() for k, v in vae.state_dict().items()}
    vstep = T.make_vae_train_step(2, scale=VAE_SCALE)

    def step1(lr=VAE_LR):
        """Step 1 from the seeded weights: its loss terms and gradients
        (``gate_step`` holds them as the update)."""
        vae.load_state_dict(vstate)
        opt = T.optim.sgd(vae.parameters(), lr)
        aux = vstep(vae, opt, lab4, torch.Generator(device="cuda")
                    .manual_seed(args.seed))
        grads = {k: p_.grad.detach().clone()
                 for k, p_ in vae.named_parameters()}
        torch.cuda.synchronize()
        return {k: v.item() for k, v in aux.items() if v.dim() == 0}, \
            grads, True

    want = expected_source_step_launches(vae, True)
    step_calls = []

    def recorded(run, expected, phase, what, timed=True):
        out, tot, calls = record_checked(run, expected, phase, what, timed)
        step_calls.append(k1_y_checks(torch, calls))
        return out, tot, calls
    gate, ok, totals["library_vae3_step"] = gate_step(
        ops, recorded, "library_vae3", step1, want)
    gate["k1_y_rule"] = step_calls[0]
    ok = ok and step_calls[0]["ok"]
    launches = added(launches, gate["launches"])
    torch.cuda.empty_cache()
    vae.load_state_dict(vstate)
    opt = T.optim.sgd(vae.parameters(), VAE_LR)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timing = timed_steps(torch, ops, lambda i: {
        k: v for k, v in vstep(vae, opt, lab4, gen).items() if v.dim() == 0})
    prof = profile_run(torch, lambda: vstep(vae, opt, lab4, gen), 2,
                       "library_vae3_step_profile", failures)
    prof["busy_share_of_step_ms"] = prof["device_ms"] / timing["step_ms"]
    emit(prof, log)
    ok = ok and timing["finite"] and all(c == want
                                         for c in timing["launches"])
    recs["library_vae3_step"] = {
        **gate, "step_ms": timing["step_ms"],
        "step_ms_all": timing["step_ms_all"],
        "enqueue_ms": timing["enqueue_ms"],
        "peak_memory_bytes": timing["peak_memory_bytes"],
        "device_ms": prof["device_ms"], "ok": ok}
    emit({"phase": "library_vae3_step", **recs["library_vae3_step"]}, log)
    if not ok:
        failures.append(f"library_vae3 step: {recs['library_vae3_step']}")
    del vae, opt, vstate
    torch.cuda.empty_cache()

    # ---- (b) norm_type 2: a SegUNet forward at batch 2, its running
    # buffers held too
    seg = SegUNet(n_class=2, generator=seeded(4), norm_type=2).cuda()
    forward_part("library_seg2", seg, img2, (0,))
    del seg
    torch.cuda.empty_cache()

    # ---- (c) SegmentationGS at DEFAULT_FMAPS, batch 1; then each
    # reparametrised conv once at a kernel's shape
    gs = SegmentationGS(n_class=2, generator=seeded(5)).cuda()
    forward_part("library_segmentation_gs", gs, image, (0,))
    del gs
    v32 = torch.randn((1, 32, 32, 32, 64), generator=seeded(6)) \
        .to("cuda", torch.bfloat16)
    for name, m in (
            ("library_gsconv3d", GSConv3d(64, 64, num_group=8,
                                          generator=seeded(7))),
            ("library_gsconv3d_k2", GSConv3d(64, 64, kernel=2, stride=2,
                                             padding="VALID",
                                             generator=seeded(8))),
            ("library_sconv3d", SConv3d(64, 64, generator=seeded(9))),
            ("library_gsconvtranspose3d", GSConvTranspose3d(
                64, 32, num_group=4, generator=seeded(10)))):
        m = m.cuda()
        kernel = {"library_gsconv3d_k2": "down_k2s2",
                  "library_gsconvtranspose3d": "up_k2s2"}.get(name, "conv3")

        def run(m=m):
            with torch.no_grad():
                return m(v32)
        want = {**{k: 0 for k in KERNEL_NAMES}, kernel: 1}
        out_p, totals[name], calls = record_checked(
            run, want, f"{name}_kernel", f"{name} forward", timed=False)
        y_rule = k1_y_checks(torch, calls) if kernel == "conv3" \
            else {"ok": True}
        del calls
        ops.reset_launch_counts()
        out_k = run()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        launches = added(launches, got)
        ok = (got == want and bool(torch.isfinite(out_k.float()).all())
              and tuple(out_k.shape) == tuple(out_p.shape)
              and y_rule["ok"])
        rec = {"phase": name, "launches": got, "launches_expected": want,
               "k1_y_rule": y_rule,
               "shape": list(out_k.shape),
               "max_abs_err": (out_k.float() - out_p.float()).abs().max()
               .item(), "ok": ok}
        emit(rec, log)
        if not ok:
            failures.append(f"{name}: {rec}")
        recs[name] = rec
    for name in LIBRARY_KERNELS:
        if launches[name] == 0:
            failures.append(f"{name} was never launched on phase 20's "
                            "passes")
    emit({"phase": "library_models_seconds",
          "seconds": time.time() - t_phase,
          "ok": all(r["ok"] for r in recs.values())}, log)
    return {"launches": launches, "totals": totals}


# ------------------------------------------------------------ phase 17: the
# mesh (ROADMAP item 9): the valid-plane range of rows 1-5 on the card, the
# adaptation step on worlds of ranks sharing the one card, both CLIs under
# torchrun

# the SP2 slabs of a stage of D planes: the first (its low halo is the
# volume's zero padding), the last (its high halo) and an interior one
SLAB_KINDS = ("first", "last", "interior")
DLIM_STAGES = (128, 64, 32, 16, 8, 4)
# the dlim calls' kernels line entries (name, the wrappers' totals key)
DLIM_KERNELS = (("conv3_dlim", ("conv3", "conv3/dx"), "conv3"),
                ("conv3_dk_dlim", ("conv3_dk",), "conv3_dk"),
                ("conv3_bwd_dlim", ("conv3_bwd",), "conv3_bwd"))
MESH_LAYOUTS = ((2, 1), (1, 2), (2, 2))   # DP2, SP2, DP2 x SP2
WORLD_TIMEOUT = 300.0


def slab(torch, v, kind: str, zero_halo: bool = False) -> tuple:
    """(slab, dlim) of v [B, D, ...]: the [B, D/2 + 2, ...] slab of a
    'spatial' rank (SP2's first or last, or an interior one centred on the
    volume) with its valid-plane range; zero_halo zeroes its two halo
    planes (a cotangent: the backward of the owned planes)."""
    d = v.shape[1]
    h = d // 2
    z = torch.zeros_like(v[:, :1])
    if kind == "first":
        s, dlim = torch.cat([z, v[:, :h + 1]], dim=1), (1, h + 1)
    elif kind == "last":
        s, dlim = torch.cat([v[:, h - 1:], z], dim=1), (0, h)
    else:
        q = d // 4
        s, dlim = v[:, q - 1:q + h + 1], (0, h + 1)
    s = s.clone(memory_format=torch.contiguous_format)
    if zero_halo:
        s[:, 0] = 0
        s[:, -1] = 0
    return s, dlim


def dlim_calls(torch, calls) -> list:
    """Phase 17(a)'s calls, from a recorded adaptation step's: for each
    stage D of DLIM_STAGES, the first K1 forward with the prologue and the
    stats epilogue, the first dx conv with the post epilogue, the first
    conv3_dk under the prologue and the merged backward of that dx / dk
    pair (``merged_calls``), each on the SP2 slabs of every kind with its
    range, the plain output computed now. Returns [{kernel, args, out,
    base, kind}]: `base` the recorded call on the whole volume."""
    from vae_segmentation_tpu_torch.ops import conv3

    def role(c):
        a = c["args"]
        if c["kernel"] == "conv3" and a["pre"] is not None and a["stats"]:
            return "fwd"
        if c["kernel"] == "conv3" and a["post"] is not None:
            return "dx"
        if c["kernel"] == "conv3_dk" and a["pre"] is not None:
            return "dk"
        if c["kernel"] == "conv3_bwd" and a["pre"] is not None:
            return "bwd"
        return None

    first = {}
    for c in calls + merged_calls(calls):
        r = role(c)
        if r is not None and c["args"]["x"].shape[1] in DLIM_STAGES:
            first.setdefault((r, c["args"]["x"].shape[1]), c)
    out = []
    plain = {"conv3": conv3.conv3_plain, "conv3_dk": conv3.conv3_dk_plain,
             "conv3_bwd": conv3.conv3_bwd_plain}
    with torch.no_grad():
        for (r, d), c in sorted(first.items()):
            a = c["args"]
            for kind in SLAB_KINDS:
                args = dict(a)
                if r == "fwd":
                    args["x"], dlim = slab(torch, a["x"], kind)
                elif r == "dx":
                    args["x"], dlim = slab(torch, a["x"], kind, True)
                    args["post"] = (slab(torch, a["post"][0], kind)[0],
                                    *a["post"][1:])
                else:
                    args["x"], dlim = slab(torch, a["x"], kind)
                    args["gy"] = slab(torch, a["gy"], kind, True)[0]
                args["dlim"] = dlim
                fn = plain[c["kernel"]]
                out.append({"kernel": c["kernel"], "args": args,
                            "out": fn(**_plain_args(fn, args)), "base": c,
                            "kind": kind, "role": r})
    return out


def _conv3_plan_of(conv3, a, epi: str) -> dict:
    x = a["x"]
    return conv3.conv3_plan(x.shape[0], tuple(x.shape[1:4]), x.shape[-1],
                            a["kweight"].shape[-1], a.get("pre") is not None,
                            epi, conv3.sm_count(x.device.index or 0))


def stitch_check(torch, slabs, log, failures) -> list:
    """Phase 17(a)'s second rule: each recorded call run by its kernel on
    the whole volume and on SP2's two slabs, the slabs put together as two
    ranks would: y's owned planes (bit for bit where the two plans add a
    voxel's K steps in the same order, else within the bf16 rule) and the
    stats less the halo planes' sums, summed (each measure against the f64
    sums of those owned planes within K1_SUM_TOL, phase 2's rule; the
    whole call's stats reported beside); dx with the halo planes' gradients added to
    their owners' planes (bf16 rule; the planes no halo touches bit for bit
    under the same plans' condition, and always for the merged backward,
    whose voxel sums do not depend on its bricks), (ds, dt), dk and db
    summed (F32_TOL of the largest element). A split count is what orders
    a K1 voxel's K steps: the same count, the same order. The call's time
    on the whole volume and on the first slab by CUDA events beside."""
    from vae_segmentation_tpu_torch.ops import conv3

    real = {name: getattr(mod, attr) for name, mod, attr, _ in kernel_ops()}
    recs = []
    by_base = {}
    for c in slabs:
        if c["kind"] != "interior":
            by_base.setdefault(id(c["base"]), []).append(c)
    with torch.no_grad():
        for pair in by_base.values():
            c0, c1 = sorted(pair, key=lambda c: c["kind"])   # first, last
            base, r = c0["base"], c0["role"]
            fn = real[base["kernel"]]
            whole = fn(**base["args"])
            g0, g1 = fn(**c0["args"]), fn(**c1["args"])
            d = base["args"]["x"].shape[1]
            h = d // 2
            rec = {"phase": "dlim_stitch", "kernel": base["kernel"],
                   "role": r, "shape": list(base["args"]["x"].shape)}
            ok = True
            rec.update(whole_ms=cuda_ms(torch, lambda: fn(**base["args"])),
                       slab_ms=cuda_ms(torch, lambda: fn(**c0["args"])))
            if r == "fwd":
                p_w = _conv3_plan_of(conv3, base["args"], "stats")
                p_s = _conv3_plan_of(conv3, c0["args"], "stats")
                same = p_w["splits"] == p_s["splits"]
                y = torch.cat([g0[0][:, 1:-1], g1[0][:, 1:-1]], dim=1)
                st = 0
                for yk, sk in (g0, g1):
                    halo = torch.stack([yk[:, 0], yk[:, -1]], dim=1).float()
                    st = st + sk - torch.stack(
                        [halo.sum(dim=(1, 2, 3)),
                         (halo * halo).sum(dim=(1, 2, 3))], dim=1)
                err = (y.float() - whole[0].float()).abs().max().item()
                scale = whole[0].float().abs().max().item()
                bitwise = torch.equal(y, whole[0])
                abs_sum = y.double().abs().sum(dim=(1, 2, 3))
                # the summation against the f64 sums of the owned planes
                # it stored (phase 2's rule); the whole call's stats beside
                st_err = stats_errors(st, stats_of(torch, y), abs_sum)
                ok = (bitwise or not same) and err <= 1e-2 * scale \
                    and all(e <= K1_SUM_TOL for e in st_err)
                rec.update(splits_whole=p_w["splits"],
                           splits_slab=p_s["splits"], same_order=same,
                           y_bitwise=bitwise, y_max_abs_err=err,
                           stats_own_sum_err=st_err[0],
                           stats_own_sumsq_rel=st_err[1],
                           stats_vs_whole=stats_errors(st, whole[1],
                                                       abs_sum))
            else:
                dx_i = {"dx": 0, "bwd": 0}.get(r)
                sums = []
                if dx_i is not None:
                    dx = torch.cat([g0[dx_i][:, 1:-1], g1[dx_i][:, 1:-1]],
                                   dim=1).float()
                    dx[:, h - 1] += g1[dx_i][:, 0].float()
                    dx[:, h] += g0[dx_i][:, -1].float()
                    want = whole[dx_i].float()
                    err = (dx - want).abs().max().item()
                    inner = torch.cat([g0[dx_i][:, 1:h], g1[dx_i][:, 2:-1]],
                                      dim=1)
                    inner_want = torch.cat([whole[dx_i][:, :h - 1],
                                            whole[dx_i][:, h + 1:]], dim=1)
                    same = r == "bwd" or (
                        _conv3_plan_of(conv3, base["args"], "post")["splits"]
                        == _conv3_plan_of(conv3, c0["args"],
                                          "post")["splits"])
                    bitwise = torch.equal(inner, inner_want)
                    ok = err <= 1e-2 * want.abs().max().item() \
                        and (bitwise or not same)
                    rec.update(dx_max_abs_err=err, dx_inner_bitwise=bitwise,
                               dx_same_order=same)
                if r == "dx":
                    sums = [(g0[1] + g1[1], whole[1], "ds_dt")]
                elif r == "dk":
                    sums = [(g0[0] + g1[0], whole[0], "dk"),
                            (g0[1] + g1[1], whole[1], "db")]
                else:
                    sums = [(g0[1] + g1[1], whole[1], "dk"),
                            (g0[2] + g1[2], whole[2], "db"),
                            (g0[3] + g1[3], whole[3], "ds_dt")]
                for got, want, name in sums:
                    e = (got - want).abs().max().item() / max(
                        want.abs().max().item(), 1e-30)
                    rec[f"{name}_rel_err"] = e
                    ok = ok and e <= F32_TOL
            rec["ok"] = ok
            emit(rec, log)
            recs.append(rec)
            if not ok:
                failures.append(f"dlim_stitch: {rec['kernel']} {r} at "
                                f"{rec['shape']}: the slabs put together "
                                "differ from the whole call")
    torch.cuda.synchronize()
    return recs


def _digest(t) -> str:
    """sha1 of a tensor's bytes."""
    import hashlib

    import torch

    b = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha1(b.numpy().tobytes()).hexdigest()


def adapt_world(rank: int, world: int, n_data: int, n_sp: int,
                path: str) -> dict:
    """Phase 17(b), a rank's side (``parallel.launch.spawn`` runs it in
    each process of a gloo world sharing the one card): phase 6's
    adaptation step 1 (the seed weights, batch, dropout generator, model
    widths and device saved at `path`) on this rank's slice of an n_data x
    n_sp mesh, its loss terms and (rank 0) gradients, the pseudo-label
    loss's step-1 gradient, digests of every gradient and updated
    parameter, whether the VAE moved, the K1 kernels' launches with a
    range, then 3 more steps timed (step_ms, peak memory), one step on the
    merged route (VAESEG_MERGED_BWD=1: conv3_bwd's launches with a range)
    and one on the norm route (VAESEG_PALLAS=1: each norm's sums added
    over the data row)."""
    import torch

    from vae_segmentation_tpu_torch import ops
    from vae_segmentation_tpu_torch import train as T
    from vae_segmentation_tpu_torch.models import Joint
    from vae_segmentation_tpu_torch.parallel import sharding as S

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    blob = torch.load(path)
    dev = torch.device(blob["device"])
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", 0)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.set_device(dev)
    mesh = S.make_mesh(n_data, n_sp)
    image = S.batch_shard(mesh, blob["image"].to(dev))
    label = S.batch_shard(mesh, blob["label"].to(dev))
    sched = T.default_sched(blob["lambda"])

    def fresh(lr):
        student = Joint(vae_decoder_dropout=0.5, **blob["model"]).to(dev)
        teacher = Joint(**blob["model"]).to(dev)
        for net in (student, teacher):
            net.load_state_dict(blob["state"])
        for p in teacher.parameters():
            p.requires_grad_(False)
        opt = T.optim.sgd(T.optim.freeze_vae(student), lr)
        gen = torch.Generator(device=dev).manual_seed(blob["seed"])
        return student, teacher, opt, gen

    def run(cfg, lr, grads_out):
        student, teacher, opt, gen = fresh(lr)
        step = T.make_adapt_step(cfg)
        with S.active(mesh):
            aux = step(student, teacher, opt, image, label, gen, sched)
        sync()
        grads = {k: p.grad.detach() for k, p in student.named_parameters()
                 if p.grad is not None}
        if rank == 0:
            grads_out.update({k: g.cpu() for k, g in grads.items()})
        return student, {k: v.item() for k, v in aux.items()}, grads

    full = T.AdaptConfig(n_class=2, domain_loss_type=8, vae_mont_number=1)
    ops.reset_launch_counts()
    grads0 = {}
    student, aux, grads = run(full, blob["lr"], grads0)
    now = student.state_dict()
    res = {"rank": rank, "mesh": [n_data, n_sp], "backend": mesh.backend,
           "aux": aux, "launches": ops.launch_counts(),
           "dlim_launches": ops.dlim_launch_counts(),
           "grad_digest": {k: _digest(g) for k, g in grads.items()},
           "param_digest": {k: _digest(v) for k, v in now.items()},
           "vae_unmoved": all(torch.equal(v, blob["state"][k].to(dev))
                              for k, v in now.items()
                              if k.startswith("Vae."))}
    del student, grads, now
    pseudo = {}
    run(T.AdaptConfig(n_class=2, only_pseudo=True), 0.0, pseudo)
    # timed: 3 more steps of the full loss after a first one
    student, teacher, opt, gen = fresh(blob["lr"])
    step = T.make_adapt_step(full)
    times = []
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(4):
        t0 = time.perf_counter()
        with S.active(mesh):
            step(student, teacher, opt, image, label, gen, sched)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    res.update(step_ms=sorted(times[1:])[1], step_ms_all=times,
               peak_memory_bytes=torch.cuda.max_memory_allocated()
               if cuda else None)
    del student, teacher, opt
    for switch, key in (("VAESEG_MERGED_BWD", "merged"),
                        ("VAESEG_PALLAS", "norm")):
        os.environ[switch] = "1"
        try:
            ops.reset_launch_counts()
            _, raux, rgrads = run(full, blob["lr"], {})
            res[key] = {"aux": raux, "launches": ops.launch_counts(),
                        "dlim_launches": ops.dlim_launch_counts(),
                        "grad_digest": {k: _digest(g)
                                        for k, g in rgrads.items()}}
            del rgrads
        finally:
            del os.environ[switch]
    if rank == 0:
        res["grads"], res["pseudo_grads"] = grads0, pseudo
    return res


def world_gate(torch, worlds: dict, ref: dict, log, failures) -> dict:
    """Phase 17(b)'s rule, per world against the one-process kernel step
    on the card (phase 6's step 1, `ref`): each loss term within phase 6's
    loss gate (DRIFT_MULTIPLE times the largest term's plain-path drift
    under reordered f32 sums, 1e-3 at least), each gradient tensor of the
    full loss and of the pseudo-label loss alone within DRIFT_MULTIPLE
    times its (or the median tensor's) plain-path drift, every rank's
    gradients and updated parameters the same bits, the VAE unmoved, K1
    launched with a range on every rank of a 'spatial' mesh (and conv3_dk,
    and on the merged route conv3_bwd); the merged and norm routes' steps
    finite, their kernels launched, the same gradient bits on every rank
    (their loss terms reported)."""
    out = {}
    for layout, ranks in worlds.items():
        r0 = ranks[0]
        grads = {k: torch.from_numpy(v) for k, v in r0["grads"].items()}
        pseudo = {k: torch.from_numpy(v)
                  for k, v in r0["pseudo_grads"].items()}
        err = grad_drift(grads, ref["grads_k"])
        drift = grad_drift(ref["grads_r"], ref["grads_p"])
        median = sorted(drift.values())[len(drift) // 2]
        worst = {k: err[k] / max(drift[k], median) for k in err}
        perr = grad_drift(pseudo, ref["pseudo_k"])
        pdrift = grad_drift(ref["pseudo_r"], ref["pseudo_p"])
        pmedian = sorted(pdrift.values())[len(pdrift) // 2]
        pworst = {k: perr[k] / max(pdrift[k], pmedian) for k in perr}
        loss_err = {k: max(abs(r["aux"][k] - ref["aux_k"][k])
                           for r in ranks) for k in ref["loss_gate_keys"]}
        spatial = layout[1] > 1
        launched = all(
            r["dlim_launches"]["conv3"] > 0
            and r["dlim_launches"]["conv3_dk"] > 0
            and r["merged"]["dlim_launches"]["conv3_bwd"] > 0
            for r in ranks) if spatial else all(
            sum(r["dlim_launches"].values()) == 0 for r in ranks)
        same = all(r["grad_digest"] == r0["grad_digest"]
                   and r["param_digest"] == r0["param_digest"]
                   and r["merged"]["grad_digest"]
                   == r0["merged"]["grad_digest"]
                   and r["norm"]["grad_digest"] == r0["norm"]["grad_digest"]
                   for r in ranks)
        # the opt-in routes' steps: finite, their kernels launched, their
        # loss terms reported beside the default route's
        routes = all(
            all(v == v and abs(v) != float("inf")
                for v in r[key]["aux"].values())
            and r[key]["launches"][kern] > 0
            for r in ranks for key, kern in (("merged", "conv3_bwd"),
                                             ("norm", "norm_bwd_sums")))
        ok = (same and launched and routes
              and all(r["vae_unmoved"] for r in ranks)
              and all(v <= ref["loss_gate"] for v in loss_err.values())
              and all(v <= DRIFT_MULTIPLE for v in worst.values())
              and all(v <= DRIFT_MULTIPLE for v in pworst.values())
              and sorted(grads) == sorted(ref["grads_k"]))
        name = f"DP{layout[0]} x SP{layout[1]}"
        rec = {"phase": "mesh_step", "mesh": name, "ranks": len(ranks),
               "backend": r0["backend"],
               "per_rank": [{f: r[f] for f in (
                   "rank", "step_ms", "step_ms_all", "peak_memory_bytes",
                   "dlim_launches")} | {"backend": r["backend"],
                   "merged_dlim_launches": r["merged"]["dlim_launches"]}
                   for r in ranks],
               "losses_rank0": r0["aux"], "losses_one_process": ref["aux_k"],
               "loss_err": loss_err, "loss_gate": ref["loss_gate"],
               "grad_worst_ratio": max(worst.values()),
               "grad_median_ratio": sorted(worst.values())[len(worst) // 2],
               "grad_rel_l2_mesh_vs_one_process": err,
               "pseudo_only_worst_ratio": max(pworst.values()),
               "ranks_bitwise_equal": same, "dlim_launched": launched,
               "routes_ok": routes,
               "merged_route_losses_rank0": r0["merged"]["aux"],
               "norm_route_losses_rank0": r0["norm"]["aux"],
               "vae_unmoved": all(r["vae_unmoved"] for r in ranks),
               "drift_multiple": DRIFT_MULTIPLE,
               "note": "ranks share one card over gloo: step_ms measures "
                       "no scaling", "ok": ok}
        emit(rec, log)
        out[name] = rec
        if not ok:
            failures.append(f"mesh_step {name}: the sharded adaptation step "
                            "disagrees with one process or between ranks")
    return out


def torchrun(argv: list, cwd: str, nproc: int, timeout: float) -> tuple:
    """``torchrun --standalone --nproc_per_node nproc`` of a module
    (``python -m torch.distributed.run``) in `cwd`, in a session of its
    own that is killed whole at the deadline: (returncode, seconds,
    stdout + stderr)."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *argv]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return -9, time.time() - t0, out
    return proc.returncode, time.time() - t0, out


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
    sass = tensor_core_sass(build)
    if sass is None:
        failures.append("no cuobjdump in the CUDA toolkit: the tensor-core "
                        "SASS check could not run")
    for n in TENSOR_CORE_LIBS:
        if sass is not None and not sum(sass[n].values()):
            failures.append(f"{n}: no tensor-core instruction in its SASS")
    for lib, kernel in TENSOR_CORE_KERNELS:
        k = None if sass is None else sass["kernels"].get(f"{lib}/{kernel}")
        if sass is not None and (not k or not k["functions"]
                                 or not k["HMMA"] + k["HGMMA"]):
            failures.append(f"{lib}/{kernel}: no tensor-core instruction in "
                            f"its functions' SASS ({k})")
    for lib, kernel in VECTOR_KERNELS:
        k = None if sass is None else sass["kernels"].get(f"{lib}/{kernel}")
        if sass is not None and (not k or not k["functions"]
                                 or not k["LDG.128"]
                                 or not (k["STG.128"]
                                         or kernel in LOAD_ONLY_KERNELS)):
            failures.append(f"{lib}/{kernel}: no 128-bit global load or "
                            f"store in its functions' SASS ({k})")
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": regs, "tensor_core_sass": sass}, log)
    # the device kernels of one norm, forward and backward, at the norm
    # route's shapes (before any other profile)
    per_norm = kernels_per_norm(torch, NORM_SHAPES, failures)
    emit({"phase": "norm_kernels_per_norm",
          "kernels": {k: {d: None if v is None else len(v)
                          for d, v in r.items()}
                      for k, r in per_norm.items()},
          "limits": [MIN_KERNELS_A_NORM, MAX_KERNELS_A_NORM],
          "names": per_norm}, log)

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

        def record_checked(run, expected, phase, what, timed=True):
            """run() on the plain path with every kernel call recorded: the
            calls per kernel against `expected`, then every call held against
            its plain version (check_step_calls; with timed=False
            check_untimed, the same rules without the timing). Returns
            run()'s result, the per-kernel totals and the calls."""
            calls = []
            with plain_ops(record=calls):
                out = run()
            torch.cuda.synchronize()
            got = count_calls(calls)
            if got != expected:
                failures.append(f"kernel calls per {what} {got} != {expected}")
            check = check_step_calls if timed else check_untimed
            return out, check(torch, calls, log, failures, phase=phase), calls

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
            emit(profile_forward(torch, model, image, failures,
                                 phase=prof_phase), log)
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
                         rec["step_ms"], prof_phase, log, failures)
            del student, teacher, opt
            torch.cuda.empty_cache()
            return rec, run["launches"]

        expected_step = expected_step_launches(model)
        (aux_p, grads_p), step_totals, calls = record_checked(
            step1, expected_step, "step_kernel", "train step")
        # ---- 17(a), while the recording is alive: the K1 kernels with a
        # valid-plane range on the SP2 slabs of the step's calls, each
        # against its plain version, and the slabs put together against
        # the whole call
        slabs = dlim_calls(torch, calls)
        dlim_totals = check_step_calls(torch, slabs, log, failures,
                                       phase="dlim_kernel")
        dlim_stitch = stitch_check(torch, slabs, log, failures)
        del calls, slabs
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
        # phase 17(b)'s reference: this one-process step 1 on the card
        mesh_ref = {"aux_k": aux_k, "loss_gate": loss_gate,
                    "loss_gate_keys": loss_keys,
                    **{f"grads_{n}": {k: v.cpu() for k, v in g.items()}
                       for n, g in (("k", grads_k), ("p", grads_p),
                                    ("r", grads_r))}}
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
        # a fixed count of warps (the timing's 2 + 5), so that the batches
        # drawn after it, phases 8-10's, do not depend on the host's clock:
        # with the kernels' sums in a fixed order, phase 9's gate then reads
        # the same on every run. Phase 9's rule holds on every draw, not on
        # this one alone (tools/vae_gate_repeat.py --draws 1-10 --calls runs
        # phase 8's per-call checks and 9's gate on each draw)
        warp_ms = cuda_ms(torch, lambda: augment.spatial_augment(
            src_img, src_lab, aug_gen, patch_size=patch),
            budget_ms=float("inf"), max_reps=5)
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
                         rec["step_ms"], prof_phase, log, failures)
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

        # ---- 9. the vae_train step-1 gate, each loss term where it is
        # well conditioned (vae_gate, vae_backward_gate): the loss terms and
        # the latent against the plain path's drift over four summation
        # orders (the convs' sums split by channels, alone and with K1's
        # norm statistics also summed in three shuffled orders), the Dice
        # term's gradient end to end, the KL term's on one shared forward
        def terms(**plain):
            vae, _, gen = vae_fresh(0.0)
            if not plain:
                return vae_terms(torch, vae, vae_batches[0], gen)
            with plain_ops(**plain):
                return vae_terms(torch, vae, vae_batches[0], gen)

        vterms_p = terms(reordered=False)
        vterms_r = terms(reordered=True)
        vterms_s = [terms(reordered=True, stats_seed=seed)
                    for seed in (1, 2, 3)]
        vterms_k = terms()
        vgate = vae_gate(torch, vterms_k, vterms_p, vterms_r, vterms_s)
        del vterms_p, vterms_r, vterms_s, vterms_k
        # the whole step on the kernel path, twice: its launches, and the
        # same bits in its losses and every gradient
        ops.reset_launch_counts()
        vaux_k, vgrads_k = vae_step1()
        vstep1_launches = ops.launch_counts()
        vaux_k2, vgrads_k2 = vae_step1()
        vrepeat = {"losses": vaux_k2 == vaux_k,
                   "grads": all(torch.equal(g_, vgrads_k2[k_])
                                for k_, g_ in vgrads_k.items())}
        finite = all(bool(torch.isfinite(g).all()) for g in vgrads_k.values())
        del vgrads_k, vgrads_k2
        if not all(vrepeat.values()):
            failures.append("vae_train step 1 on the kernel path did not "
                            "repeat bit for bit")
        vfwd = forward_launches(vae0)
        vb_expected = {k: vexpected[k] - vfwd[k] for k in KERNEL_NAMES}
        vb_expected["reparam_kl"] = 0
        vae, _, gen = vae_fresh(0.0)
        vbwd = vae_backward_gate(torch, ops, vae, vae_batches[0], gen,
                                 vb_expected)
        del vae
        vstep1_ok = (vstep1_launches == vexpected and vgate["ok"]
                     and vbwd["backward_ok"] and finite)
        if not vstep1_ok:
            failures.append("vae_train step 1 with kernels disagrees with "
                            "the plain path")
        emit({"phase": "vae_step1", "batch": VAE_BATCH, "scale": VAE_SCALE,
              "launches": vstep1_launches, "launches_expected": vexpected,
              **vgate, **vbwd, "losses_step_kernels": vaux_k,
              "losses_step_plain": vaux_p, "grads_finite": finite,
              "kernel_path_repeats_bitwise": vrepeat,
              "losses_kernels_again": vaux_k2, "ok": vstep1_ok}, log)
        del vgrads_p
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
            shapes = {tuple(c["args"]["x"].shape) for c in calls
                      if c["kernel"] == "norm_apply"}
            del calls
            if shapes != set(NORM_SHAPES):
                failures.append(f"the norm route's forward took norms of "
                                f"{sorted(shapes)}, phase 1 counted "
                                f"{list(NORM_SHAPES)}")
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
        # pair's plain outputs); now step 1 on the merged route twice (its
        # launches, the same bits in its losses and every gradient), its
        # backward against the plain backward on one shared forward
        # (vae_backward_gate's rule), and phase 10's steps
        mexpected = {**vexpected, "conv3_bwd": vexpected["conv3_dk"] - 1,
                     "conv3_dk": 1,
                     "conv3": vexpected["conv3"] - vexpected["conv3_dk"] + 1}
        mb_expected = {**vb_expected, "conv3_bwd": mexpected["conv3_bwd"],
                       "conv3_dk": 1, "conv3": vb_expected["conv3"]
                       - mexpected["conv3_bwd"]}
        with route("VAESEG_MERGED_BWD"):
            ops.reset_launch_counts()
            maux_k, mgrads_k = vae_step1()
            mstep1_launches = ops.launch_counts()
            maux_k2, mgrads_k2 = vae_step1()
            mrepeat = {"losses": maux_k2 == maux_k,
                       "grads": all(torch.equal(g_, mgrads_k2[k_])
                                    for k_, g_ in mgrads_k.items())}
            mfinite = all(bool(torch.isfinite(g).all())
                          for g in mgrads_k.values())
            del mgrads_k, mgrads_k2
            vae, _, gen = vae_fresh(0.0)
            mbwd = vae_backward_gate(torch, ops, vae, vae_batches[0], gen,
                                     mb_expected)
            del vae
            torch.cuda.empty_cache()
            mstep1_ok = (mstep1_launches == mexpected and mfinite
                         and all(mrepeat.values()) and mbwd["backward_ok"])
            if not mstep1_ok:
                failures.append("merged route: vae_train step 1 did not "
                                "repeat bit for bit or its backward "
                                "disagrees with the plain backward")
            emit({"phase": "merged_vae_step1", "batch": VAE_BATCH,
                  "launches": mstep1_launches,
                  "launches_expected": mexpected,
                  "kernel_path_repeats_bitwise": mrepeat,
                  "losses_kernels": maux_k, "losses_kernels_again": maux_k2,
                  "grads_finite": mfinite, **mbwd,
                  "drift_multiple": DRIFT_MULTIPLE, "ok": mstep1_ok}, log)
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

        # ---- 14. test time on the default route: ft1 on the crop eval,
        # one ft1 step's calls and gates, the sliding window alone,
        # post-processed and composed with ft1
        tt = test_time(torch, ops, run_cli, record_checked, model, image,
                       label, work, data, manifest, args, log, failures)
        test_time_launches = tt["launches"]

        # ---- 15. the runs that outlive one process and the last training
        # flags: --resume of both CLIs, the source replay (--pseudo_list),
        # the cubic warp (--aug_order 3) and the host warp (--aug_host)
        replay_lists = os.path.join(work, "lists_replay.json")
        with open(replay_lists, "w") as f:
            json.dump({"NIH_train": train_entries, "NIH_val": entries,
                       "SRC": src_entries}, f)
        lf = later_flags(torch, ops, run_cli, record_checked, model, batches,
                         (src_img, src_lab),
                         {"work": work, "data": data,
                          "train_data": train_data, "src_data": src_data,
                          "src_lists": src_lists,
                          "replay_lists": replay_lists},
                         args, log, failures)
        later_launches = lf["launches"]

        # ---- 16. the host data layer: the native loader and resize against
        # the numpy path, case by case, and the eval CLI on each path
        host_data(run_cli, target_main, work, data, manifest, args, log,
                  failures)

        # ---- 17(b). the adaptation step on worlds of ranks sharing this
        # card over gloo (DP2, SP2, DP2 x SP2), against phase 6's step 1
        from vae_segmentation_tpu_torch.parallel import launch

        with plain_ops(reordered=True):
            mesh_ref["pseudo_r"] = {k: v.cpu() for k, v in
                                    step1(seg_step)[1].items()}
        with plain_ops():
            mesh_ref["pseudo_p"] = {k: v.cpu() for k, v in
                                    step1(seg_step)[1].items()}
        mesh_ref["pseudo_k"] = {k: v.cpu() for k, v in
                                step1(seg_step)[1].items()}
        blob = os.path.join(work, "mesh_step.pt")
        torch.save({"state": state0, "image": batches[0][0].cpu(),
                    "label": batches[0][1].cpu(), "seed": args.seed,
                    "lr": TRAIN_LR, "lambda": TRAIN_LAMBDA,
                    "device": "cuda", "model": dict(
                        n_class=2, dim=128, bottleneck=16384)}, blob)
        torch.cuda.empty_cache()
        worlds = {}
        for n_data, n_sp in MESH_LAYOUTS:
            t0 = time.time()
            worlds[n_data, n_sp] = launch.spawn(
                adapt_world, n_data * n_sp, backend="gloo",
                timeout=WORLD_TIMEOUT, args=(n_data, n_sp, blob), threads=2)
            emit({"phase": "mesh_world", "mesh": [n_data, n_sp],
                  "seconds": time.time() - t0}, log)
        mesh_steps = world_gate(torch, worlds, mesh_ref, log, failures)
        # the K1 kernels' launches with a range on the sharded steps 1 (and
        # conv3_bwd's on the merged route's step)
        mesh_launches = {"conv3": 0, "conv3_dk": 0, "conv3_bwd": 0}
        for ranks in worlds.values():
            for r in ranks:
                for name in ("conv3", "conv3_dk"):
                    mesh_launches[name] += r["dlim_launches"][name]
                mesh_launches["conv3_bwd"] += \
                    r["merged"]["dlim_launches"]["conv3_bwd"]
        del worlds, mesh_ref

        # ---- 17(c). both CLIs under torchrun on 2 ranks of this card, one
        # epoch each, against the same run in one process
        mesh_cli = {}
        mesh_args = ["--train_list", "NIH_train", "--val_list", "NIH_val",
                  "--data_root", train_data, "--val_data_root", data,
                  "--data_path", lists, "-b", str(TRAIN_BATCH),
                  "--val_batch", "1", "--eval_epoch", "1", "--save_epoch",
                  "1", "--num_workers", "2", "--save_root",
                  os.path.join(work, "3dmodel"), "--device", "cuda"]
        runs = {
            "mesh_vae": ("source_main", [
                "--method", "vae_train", "--max_epoch", "1", "--lr_seg",
                str(VAE_LR), *mesh_args], []),
            "mesh_sp": ("target_main", [
                "--method", "domain_adaptation", "--load_prefix",
                "smoke_seg", "--load_prefix_vae", "smoke",
                "--domain_loss_type", "8", "--lambda_vae",
                str(TRAIN_LAMBDA), "--lr_seg", str(TRAIN_LR),
                "--vae_decoder_dropout", "0.5", "--max_epoch", "2",
                *mesh_args], ["--spatial_shards", "2"]),
        }
        mesh_cli_ok = True
        for prefix, (mod, argv, mesh_flags) in runs.items():
            cli = source_main if mod == "source_main" else target_main
            run_cli(cli.main, [prefix + "_one", *argv])
            rc, secs, out = torchrun(
                ["-m", f"vae_segmentation_tpu_torch.cli.{mod}", prefix,
                 *argv, *mesh_flags], work, 2, WORLD_TIMEOUT)
            epochs = (0,) if mod == "source_main" else (0, 1)
            got = read_scores(work, prefix, epochs)
            want = read_scores(work, prefix + "_one", epochs)
            diff = max((abs(g[k] - w[k]) for g, w in zip(got, want)
                        for k in w), default=None)
            ok = (rc == 0 and len(got) == len(epochs) and diff is not None
                  and all(g.keys() == w.keys() for g, w in zip(got, want))
                  and diff <= 0.01
                  and len(saved_checkpoints(work, prefix)) >= 2
                  and "backend gloo" in out)
            mesh_cli[prefix] = {"returncode": rc, "seconds": secs,
                                "scores": got, "scores_one_process": want,
                                "max_dice_diff": diff, "ok": ok,
                                "tail": out[-2000:]}
            mesh_cli_ok = mesh_cli_ok and ok
        rc, secs, out = torchrun(
            ["-m", "vae_segmentation_tpu_torch.cli.target_main", "mesh_ev",
             "--method", "domain_adaptation", "--test_only",
             "--load_prefix_joint", "mesh_sp", "--spatial_shards", "2",
             *mesh_args], work, 2, WORLD_TIMEOUT)
        got = read_scores(work, "mesh_ev", (0,))
        # the checkpoint is the run's best outer epoch: the first whose mean
        # Dice beat every earlier one's
        trained = read_scores(work, "mesh_sp", (0, 1))
        means = [sum(sc.values()) / max(len(sc), 1) for sc in trained]
        best = trained[1] if len(means) == 2 and means[1] > means[0] \
            else trained[0] if trained else {}
        ev_ok = rc == 0 and len(got) == 1 and got[0].keys() == best.keys() \
            and all(abs(got[0][k] - v) <= 0.01 for k, v in best.items())
        mesh_cli["mesh_ev"] = {"returncode": rc, "seconds": secs,
                               "scores": got, "best_epoch_scores": best,
                               "ok": ev_ok, "tail": out[-2000:]}
        mesh_cli_ok = mesh_cli_ok and ev_ok
        if not mesh_cli_ok:
            failures.append("the CLIs under torchrun failed a check")
        emit({"phase": "mesh_cli", "runs": mesh_cli, "dice_gate": 0.01,
              "ok": mesh_cli_ok}, log)

        # ---- 18. the serving outputs and observability of the eval CLI,
        # one step of each Joint source method, their source CLI runs
        sm = serving_and_methods(torch, ops, run_cli, record_checked, model,
                                 work, data, manifest, train_data, lists,
                                 args, log, failures)
        serving_launches = sm["launches"]

        # ---- 19. the Joint's last models and methods: the soft-ReLU VAE,
        # the discriminator methods and Embed's, their steps and CLIs
        rm = remaining_methods(torch, ops, run_cli, record_checked, work,
                               data, manifest, train_data, lists, args, log,
                               failures)
        remaining_launches = rm["launches"]

        # ---- 20. the library-only models: norm types 2 and 3 through the
        # models, the GS family
        lm = library_models(torch, ops, record_checked, image, train_data,
                            lists, args, log, failures)
        library_launches = lm["launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 21. summary lines: K1-K3 per eval forward (phase 2), the backward
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
        elif name == "reparam_kl_vjp":
            t, per = vae_totals[name], f"vae_train step, batch {VAE_BATCH}"
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
            "timed_by": "cuda graph replay" if name in GRAPH_TIMED
            else "profiler device time" if name == "reparam_kl"
            else "cuda events"}
        rec.update({f: t[f] for f in (
            "graph_ms", "library_graph_ms", "plain_graph_ms",
            "kernel_events_ms", "launch_floor_ms", "launch_floor_events_ms",
            "wrapper_host_ms", "split_calls", "split_ms",
            "onepass_ms", "split_graph_ms", "onepass_graph_ms", "dx_ms")
            + DX_FIELDS + PLAN_FIELDS if f in t})
        if name in route_of:
            switch, launched = route_of[name]
            rec.update(launches=launched[name], path=switch)
            rec.update({f: t[f] for f in ("pair_ms", "pair_graph_ms")
                        if f in t})
            if launched[name] == 0:
                failures.append(f"{name} was never launched on its route "
                                f"({switch})")
        else:
            rec.update(launches=eval_launches[name] + train_launches[name]
                       + test_time_launches[name] + later_launches[name]
                       + serving_launches[name]
                       + remaining_launches[name] + library_launches[name],
                       launches_eval_path=eval_launches[name],
                       launches_train_path=train_launches[name],
                       launches_test_time_path=test_time_launches[name],
                       launches_later_flags_path=later_launches[name],
                       launches_serving_and_methods_path=serving_launches[
                           name],
                       launches_remaining_methods_path=remaining_launches[
                           name],
                       launches_library_models_path=library_launches[name])
            if train_launches[name] == 0 or \
                    (name in PER_FORWARD and eval_launches[name] == 0):
                failures.append(f"{name} was never launched on its main "
                                "path")
            if test_time_launches[name] == 0 and name in TEST_TIME_KERNELS:
                failures.append(f"{name} was never launched on the test-time "
                                "path (phase 14)")
            if later_launches[name] == 0 and name in LATER_FLAGS_KERNELS:
                failures.append(f"{name} was never launched on the runs of "
                                "phase 15")
        kernels.append(rec)
    # the K1 kernels with a valid-plane range (phase 17): their slab calls'
    # totals (phase 17(a)) and their launches on the sharded steps (17(b))
    for name, keys, base in DLIM_KERNELS:
        parts = [dlim_totals[k] for k in keys if k in dlim_totals]
        t = {f: sum(p_[f] for p_ in parts) for f in (
            "kernel_ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
            "calls")}
        libs = [p_["library_ms"] for p_ in parts]
        source, replaces = SOURCES[base]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces + " (with its dlim operand)",
            "launches": mesh_launches[base],
            "max_abs_err": max((p_["err"] for p_ in parts), default=None),
            "max_rel_err_bf16": max((p_["bf16_rel_err"] for p_ in parts),
                                    default=None),
            "max_rel_err_f32": max((p_["f32_rel_err"] for p_ in parts),
                                   default=None),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations",
            "library_ms": None if None in libs else sum(libs),
            "slab_calls": t["calls"],
            "per": "the SP2 slab calls (first, last and interior range) of "
                   "one adaptation step's prologue convs at D 128-4, batch "
                   f"{TRAIN_BATCH}",
            "timed_by": "cuda events",
            "path": "phase 17(b): the sharded adaptation steps 1 (DP2, SP2, "
                    "DP2 x SP2) on ranks sharing one card over gloo"
                    + ("; VAESEG_MERGED_BWD=1" if base == "conv3_bwd"
                       else "")})
        if not parts or mesh_launches[base] == 0:
            failures.append(f"{name}: no slab call checked or no launch on "
                            "the sharded steps")
    emit({"phase": "dlim_totals", "per_step": dlim_totals,
          "stitch": dlim_stitch, "mesh_steps": {
              k: {f: v[f] for f in ("per_rank", "ok")}
              for k, v in mesh_steps.items()}}, log)
    emit({"phase": "step_totals", "per_kernel": step_totals}, log)
    emit({"phase": "vae_step_totals", "per_kernel": vae_totals}, log)
    emit({"phase": "norm_totals", "per_forward": norm_fwd_totals,
          "per_step": norm_step_totals}, log)
    emit({"phase": "merged_totals", "per_vae_step": merged_totals}, log)
    emit({"phase": "test_time_totals", "per_ft1_step": tt["ft1_totals"],
          "per_window_chunk": tt["sw_totals"]}, log)
    emit({"phase": "later_flags_totals",
          "per_replay_step": lf["replay_totals"]}, log)
    emit({"phase": "joint_source_step_totals",
          "per_step": sm["step_totals"]}, log)
    emit({"phase": "remaining_step_totals",
          "per_step": rm["step_totals"]}, log)
    emit({"phase": "library_models_totals", "per_pass": lm["totals"]}, log)
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
