"""The Joint's source steps under a mesh (``parallel/``), in gloo worlds on
the CPU: joint_train and the source domain_adaptation (the cached pseudo
label) at 32^3 under DP2 against the one-process port step, with
tests/test_torch_dist_step.py's rules (tests/test_torch_source_methods.py
and tests/test_torch_cached_pseudo.py hold the one-process steps to
JAX's)."""

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from test_torch_dist_step import (LOSS_ABS, DRIFT_MULTIPLE, SIZE, _case,
                                  _reordered, _spec, drift_ratios)
from vae_segmentation_tpu_torch.parallel import launch

torch.set_num_threads(2)



@pytest.mark.parametrize("kind", ["joint", "cached"])
def test_joint_source_steps_under_dp2(kind):
    """joint_train and the source domain_adaptation (its cached pseudo
    label sliced as the batch) at 32^3 under DP2: the loss terms and every
    gradient the one-process step's (the drift rule above), the same bits
    on both ranks, the VAE unmoved; the cached step's prediction gathered
    over 'data' (the --mode refresh's) within 1e-5 of one process's."""
    params, batches = _case(SIZE)
    p1 = np.random.default_rng(5).random(batches[0][1].shape) \
        .astype(np.float32)
    spec = dict(_spec(params, batches[0]), kind=kind,
                pseudo=np.stack([1.0 - p1, p1], axis=-1))
    one = W.joint_step(0, 1, 1, 1, spec)
    reordered = _reordered(W.joint_step, spec)
    ranks = launch.spawn(W.joint_step, 2, timeout=120.0, args=(2, 1, spec))
    for r in ranks:
        assert r["aux"].keys() == one["aux"].keys()
        for k, v in one["aux"].items():
            assert r["aux"][k] == pytest.approx(v, abs=LOSS_ABS), k
        assert r["vae_unmoved"]
    for k, ratio in drift_ratios(ranks[0]["grads"], one["grads"],
                                 reordered["grads"])[2].items():
        assert ratio <= DRIFT_MULTIPLE, (k, ratio)
    assert ranks[1]["grad_digest"] == ranks[0]["grad_digest"]
    if kind == "cached":
        for r in ranks:
            got, want = np.asarray(r["pred"]), np.asarray(one["pred"])
            assert got.shape == want.shape == (2, SIZE, SIZE, SIZE, 2)
            assert np.abs(got - want).max() <= 1e-5


def test_pseudo_cache_under_dp2(tmp_path):
    """The source CLI's domain_adaptation with --mode 1 as a 2-rank world
    sharing one directory (as torchrun runs it), DP2 at 32^3 full width:
    rank 0 alone fills the cache and, after every step, writes the
    predictions gathered over 'data'; the other rank waits at the barrier
    and reads its slice. The cache ends near one process's (the
    refreshed bf16 predictions follow an update that the mesh sums in
    another order: their mean distance from one process's is held under a
    quarter of the distance to any other case's prediction,
    0.03-0.09 of it measured) and the scores
    within chip_smoke.py phase 3's Dice gate."""
    import os

    from vae_segmentation_tpu_torch.cli import source_main
    from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
    from vae_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)
    from vae_segmentation_tpu_torch.models import Joint

    write_synthetic_dataset(str(tmp_path / "data"), n_train=4, n_val=1,
                            size=40, seed=0)
    joint = Joint(n_class=2, bottleneck=256,
                  generator=torch.Generator().manual_seed(3))
    for d in ("one", "shared"):
        save_checkpoint(str(tmp_path / d / "3dmodel" / "j0" /
                            "best_model.ckpt"), epoch=0, model=joint)
    argv = ["da", "--method", "domain_adaptation", "--load_prefix_joint",
            "j0", "--mode", "1", "--no_aug", "--train_list", "NIH_train",
            "--val_list", "NIH_val", "--data_root", str(tmp_path / "data"),
            "--val_data_root", str(tmp_path / "data"),
            "--data_path", str(tmp_path / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--max_epoch", "2", "--num_workers", "0",
            "--device", "cpu"]
    old = os.getcwd()
    os.chdir(tmp_path / "one")
    try:
        best = source_main.main(argv)
    finally:
        os.chdir(old)
    shared = str(tmp_path / "shared")
    (best0, out0), (best1, out1) = launch.spawn(
        W.cli, 2, timeout=120.0, args=("source", argv, [shared, shared]))
    assert out1 == "" and "[  2,   2] loss: " in out0
    assert best1 == best0 and abs(best0 - best) <= 0.01
    one_cache = tmp_path / "one" / "domain_cache" / "da"
    mesh_cache = tmp_path / "shared" / "domain_cache" / "da"
    names = sorted(os.listdir(one_cache))
    assert names == sorted(os.listdir(mesh_cache)) == \
        [f"{i}_pred.npy" for i in range(4)]
    ones = [np.load(one_cache / n) for n in names]
    for n, a in zip(names, ones):
        b = np.load(mesh_cache / n)
        assert a.shape == b.shape == (32, 32, 32, 2)
        # bf16 predictions: one-ulp flips after an update summed in another
        # order, far below the distance between two cases' predictions
        # (a case written in another's place)
        err = np.abs(a - b).mean()
        other = min(np.abs(a - o).mean() for o in ones if o is not a)
        assert err <= 0.25 * other, (n, err, other)
