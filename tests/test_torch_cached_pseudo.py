"""The source CLI's domain_adaptation (the cached pseudo label) of the
port against the JAX package on the CPU: ``make_cached_pseudo_adapt_step``
held to JAX's ``make_cached_pseudo_adapt_step`` for two SGD steps at 64^3
by tests/test_torch_source_methods.py's machinery and tolerances (kind
'cached'), its turn schedule and returned prediction; then the source
CLI's three Joint methods at 32^3 full width, ``--device cpu``: the pseudo
cache (``cli/source_main.py::PseudoCache``) against the JAX CLI's file
names, shapes and --mode refresh, joint_train and sep_joint_train (its
teacher from either source) end to end."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_source_methods import (
    LAMBDA, NC, SIZE, _RUN, _inputs, _port_joint)
from test_torch_source_methods import test_loss_terms_match_jax as _losses
from test_torch_source_methods import test_seg_gradients_match_jax as _grads
from test_torch_source_methods import test_vae_stays_frozen as _frozen
from vae_segmentation_tpu.cli import source_main as jsource
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.cli import source_main
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.data.pipeline import (
    CaseDataset, intensity_normalize)
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.data.transforms import parse_pan_index

torch.set_num_threads(2)


def test_cached_loss_terms_match_jax():
    _losses("cached")


def test_cached_seg_gradients_match_jax():
    _grads("cached")


def test_cached_vae_stays_frozen():
    _frozen("cached")


def test_cached_step_returns_its_prediction_and_turn_schedule():
    """'pred' is the step's forward (the --mode refresh writes it); with
    --turn_epoch, phase 0 trains on 2 lambda recon alone and phase 1 on
    lambda recon + fake (main_source.py:527-531)."""
    inputs = _RUN.get("inputs") or _inputs()
    params, _, batches, pseudos = inputs
    model = _port_joint(SIZE)
    pm.load_state(model, pm.from_jax_params(params))
    img, lab = (torch.from_numpy(a) for a in batches[0])
    opt = pt.optim.sgd(pt.optim.freeze_vae(model), 0.0)
    step = pt.make_cached_pseudo_adapt_step(
        pt.AdaptConfig(n_class=NC, turn_enabled=True))
    ps = torch.from_numpy(pseudos[0])
    for phase in (0, 1):
        sched = dict(pt.default_sched(LAMBDA), turn_phase=phase)
        aux = step(model, opt, img, lab, ps, sched)
        r, f = float(aux["recon_loss"]), float(aux["dice_loss_fake"])
        want = 2.0 * LAMBDA * r if phase == 0 else LAMBDA * r + f
        assert float(aux["final_loss"]) == pytest.approx(want, rel=1e-6)
    with torch.no_grad():
        pred = model(img[..., None])[0]
    assert torch.equal(aux["pred"], pred)



# ---- the CLI: the pseudo cache and the three methods end to end


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_source_methods")
    write_synthetic_dataset(str(root / "data"), n_train=4, n_val=2, size=40,
                            seed=0)
    joint = pm.Joint(n_class=2, bottleneck=256,
                     generator=torch.Generator().manual_seed(1))
    save_checkpoint(str(root / "3dmodel" / "j0" / "best_model.ckpt"),
                    epoch=0, model=joint)
    save_checkpoint(str(root / "3dmodel" / "s0" / "best_model.ckpt"),
                    epoch=0, model=joint.Seg)
    save_checkpoint(str(root / "3dmodel" / "v0" / "best_model.ckpt"),
                    epoch=0, model=joint.Vae)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _argv(root, prefix, method, *extra):
    return [prefix, "--method", method, "--train_list", "NIH_train",
            "--val_list", "NIH_val", "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch",
            "1", "--save_epoch", "1", "--max_epoch", "2", "--num_workers",
            "0", "--no_aug", "--device", "cpu", *extra]


def test_pseudo_cache_names_shapes_and_refresh_match_jax(workdir, capsys):
    """Outer epoch 0 writes <middle_path>/<case>_pred.npy, the starting
    Joint's [D, H, W, 2] f32 prediction of every train case (the JAX
    CLI's ``_pseudo_path`` and ``_cache_pseudo_labels``); --mode 1
    refreshes each batch's cases from the step's prediction in every
    trained epoch (epoch 0 trains no step): the file holds the last
    prediction written, which after the first update is no longer the
    starting one."""
    loaded, written = [], {}
    real_slice = source_main.PseudoCache.slice
    real_refresh = source_main.PseudoCache.refresh

    def spy(self, index, device):
        out = real_slice(self, index, device)
        loaded.append((list(np.asarray(index)), out.clone()))
        return out

    def spy_refresh(self, index, pred):
        for i, c in enumerate(np.asarray(index)):
            written[int(c)] = pred[i].float().clone()
        return real_refresh(self, index, pred)

    source_main.PseudoCache.slice = spy
    source_main.PseudoCache.refresh = spy_refresh
    try:
        source_main.main(_argv(workdir, "da", "domain_adaptation",
                               "--load_prefix_joint", "j0", "--mode", "1"))
    finally:
        source_main.PseudoCache.slice = real_slice
        source_main.PseudoCache.refresh = real_refresh
    out = capsys.readouterr().out
    cfg = jsource.parse_source_args(_argv(workdir, "da", "domain_adaptation")
                                    [:-2])
    cases = sorted(os.listdir(cfg.middle_path))
    assert cases == sorted(os.path.basename(jsource._pseudo_path(cfg, i))
                           for i in range(4))
    joint = pm.Joint(n_class=2, bottleneck=256)
    pm.load_state(joint, "3dmodel/j0/best_model.ckpt")
    # the first batch read at epoch 1 is the epoch-0 cache: the starting
    # Joint's prediction of those cases
    (index, pseudo), = loaded[:1]
    with open(workdir / "data" / "Multi_all.json") as f:
        entries = json.load(f)["NIH_train"]
    ds = CaseDataset(entries, str(workdir / "data"), parse_pan_index("1"),
                     (32, 32, 32))
    with torch.no_grad():
        img = intensity_normalize(torch.from_numpy(np.stack(
            [ds[int(i)]["image"] for i in index])))
        want = joint.segment(img[..., None]).float()
    assert pseudo.shape == (2, 32, 32, 32, 2) and pseudo.dtype == \
        torch.float32
    torch.testing.assert_close(pseudo, want, rtol=0, atol=0)
    assert sorted(written) == [0, 1, 2, 3]
    for c, pred in written.items():
        saved = np.load(jsource._pseudo_path(cfg, c))
        assert saved.shape == (32, 32, 32, 2) and saved.dtype == np.float32
        assert np.array_equal(saved, pred.numpy())
    # the second batch's step ran after one update: its prediction is no
    # longer the cached starting one it read
    index2, pseudo2 = loaded[1]
    assert all(not torch.equal(written[int(c)], pseudo2[j])
               for j, c in enumerate(index2))
    assert "[  2,   1] loss:" in out and "[  1," not in out


@pytest.mark.parametrize("method,extra", [
    ("joint_train", ["--load_prefix", "s0", "--load_prefix_vae", "v0"]),
    ("sep_joint_train", ["--load_prefix_joint", "j0"]),
    ("sep_joint_train", ["--load_prefix", "s0", "--load_prefix_vae", "v0"]),
])
def test_joint_methods_train_from_epoch_zero(workdir, capsys, method,
                                             extra):
    """joint_train and sep_joint_train step in outer epoch 0 (no skip),
    print their loss terms, keep the VAE frozen, write scores and the
    saver's lines; sep_joint_train's teacher comes from either source."""
    prefix = method + str(len(extra))
    source_main.main(_argv(workdir, prefix, method, *extra))
    out = capsys.readouterr().out
    assert out.count("[  1, ") == 2 and out.count("[  2, ") == 2
    line = next(ln for ln in out.splitlines() if ln.startswith("[  1,"))
    assert len(line.split("loss:")[1].split(",")) == 2
    assert "val_result " in out
    vae0 = torch.load("3dmodel/v0/best_model.ckpt")["model_state_dict"]
    last = torch.load(f"3dmodel/{prefix}/model_epoch2.ckpt")
    sd = last["model_state_dict"]
    assert all(torch.equal(sd["Vae." + k], v) for k, v in vae0.items())
    with open(f"tensorboard/{prefix}/score_1.json") as f:
        assert sorted(json.load(f)) == ["0", "1"]


def test_sep_joint_train_needs_a_teacher(workdir):
    with pytest.raises(ValueError, match="teacher"):
        source_main.main(_argv(workdir, "x", "sep_joint_train"))
