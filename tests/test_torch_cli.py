"""The port's eval entry point and its host side: the target CLI end to end
on the CPU (``--device cpu``, synthetic cases at 32^3, full width), the
device rule, flag combinations not ported yet, import hygiene, and the
losses / data copies against the JAX package's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_segmentation_tpu.data import augment as jaug
from vae_segmentation_tpu.data.pipeline import CaseDataset as JCaseDataset
from vae_segmentation_tpu.data.transforms import parse_pan_index
from vae_segmentation_tpu.ops import losses as JL
from vae_segmentation_tpu_torch.cli import target_main
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.core.device import resolve_device
from vae_segmentation_tpu_torch.data import pipeline as pp
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_joint_eval_step, run_eval)
from vae_segmentation_tpu_torch.models import Joint, load_state
from vae_segmentation_tpu_torch.ops import losses as PL
from vae_segmentation_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    write_synthetic_dataset(str(root / "data"), n_train=0, n_val=3, size=40,
                            seed=0)
    model = Joint(n_class=2, bottleneck=256,
                  generator=torch.Generator().manual_seed(0))
    save_checkpoint(str(root / "3dmodel" / "jp" / "best_model.ckpt"),
                    epoch=0, model=model)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _argv(root, *extra):
    return ["ev", "--method", "domain_adaptation", "--test_only",
            "--load_prefix_joint", "jp", "--val_list", "NIH_val",
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", *extra]


def test_cli_eval_writes_scores_equal_to_eval_step(workdir):
    dsc = target_main.main(_argv(workdir, "--device", "cpu",
                                 "--val_batch", "2"))
    with open("tensorboard/ev/score_0.json") as f:
        scores = json.load(f)
    assert sorted(scores) == ["0", "1", "2"]
    assert all(0.0 <= v <= 1.0 for v in scores.values())
    assert dsc == pytest.approx(np.mean(list(scores.values())))

    model = Joint(n_class=2, bottleneck=256)
    load_state(model, "3dmodel/jp/best_model.ckpt")
    with open(workdir / "data" / "Multi_all.json") as f:
        entries = json.load(f)["NIH_val"]
    ds = pp.CaseDataset(entries, str(workdir / "data"), parse_pan_index("1"),
                        (32, 32, 32))
    batches = ({**b, "image_norm": pp.intensity_normalize(
        torch.from_numpy(b["image"]))} for b in pp.iterate_batches(ds, 2))
    _, want = run_eval(batches, make_joint_eval_step(model.eval(), 2))
    assert {int(k): v for k, v in scores.items()} == want
    assert build.loaded() == []  # the CPU never builds a kernel


def test_cli_without_gpu_or_cpu_request_raises(workdir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        target_main.main(_argv(workdir))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("extra", [
    ["--val_finetune", "1"],
    ["--eval_mode", "sliding_window"],
    ["--load_prefix", "seg"],
    ["--save_eval_result"],
])
def test_cli_unported_flags_raise(workdir, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        target_main.main(_argv(workdir, "--device", "cpu", *extra))


def test_cli_unported_methods_raise(workdir):
    argv = _argv(workdir, "--device", "cpu")
    argv[2] = "vae_train"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        target_main.main(argv)
    argv = [a for a in _argv(workdir, "--device", "cpu") if a != "--test_only"]
    argv[2] = "discriminator_train"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        target_main.main(argv)


def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        "import vae_segmentation_tpu_torch\n"
        "import vae_segmentation_tpu_torch.cli.target_main\n"
        "import vae_segmentation_tpu_torch.models, vae_segmentation_tpu_torch.ops\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'vae_segmentation_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_losses_match_jax(rng):
    pred = rng.random((2, 6, 5, 4, 3)).astype(np.float32)
    pred[0, 0, 0, 0] = [0.4, 0.4, 0.2]  # argmax tie: first max wins
    label = rng.integers(0, 3, (2, 6, 5, 4)).astype(np.float32)
    tp, jp = torch.from_numpy(pred), jnp.asarray(pred)
    oh_t = PL.one_hot_label(torch.from_numpy(label), 3, torch.float32)
    oh_j = JL.one_hot_label(jnp.asarray(label), 3, jnp.float32)
    np.testing.assert_array_equal(oh_t.numpy(), np.asarray(oh_j))
    np.testing.assert_array_equal(PL.onehot_argmax(tp).numpy(),
                                  np.asarray(JL.onehot_argmax(jp)))
    np.testing.assert_array_equal(PL.binarize(tp).numpy(),
                                  np.asarray(JL.binarize(jp)))
    np.testing.assert_allclose(PL.dice(tp, oh_t).numpy(),
                               np.asarray(JL.dice(jp, oh_j)), rtol=1e-6)
    np.testing.assert_allclose(
        PL.soft_dice_per_class(tp, oh_t).numpy(),
        np.asarray(JL.soft_dice_per_class(jp, oh_j)), rtol=1e-6)
    for kw in (dict(binary=True, botindex=1, topindex=3, return_mean=False),
               dict(binary=False, eps=PL.SOURCE_EPS),
               dict(binary=True, eps=PL.EVAL_EPS)):
        np.testing.assert_allclose(PL.avg_dsc(tp, oh_t, **kw).numpy(),
                                   np.asarray(JL.avg_dsc(jp, oh_j, **kw)),
                                   rtol=1e-6, err_msg=str(kw))
    assert (PL.EVAL_EPS, PL.SOURCE_EPS) == (JL.EVAL_EPS, JL.SOURCE_EPS)


def test_case_dataset_and_normalize_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")  # the scipy resize path
    write_synthetic_dataset(str(tmp_path), n_train=0, n_val=2, size=36,
                            seed=4)
    with open(tmp_path / "Multi_all.json") as f:
        entries = json.load(f)["NIH_val"]
    mi = parse_pan_index("1")
    port = pp.CaseDataset(entries, str(tmp_path), mi, (32, 32, 32))
    ref = JCaseDataset(entries, str(tmp_path), mi, (32, 32, 32))
    for i in range(2):
        a, b = port[i], ref[i]
        np.testing.assert_allclose(a["image"], b["image"], rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["ori_shape"], b["ori_shape"])
    batch = next(pp.iterate_batches(port, 2))
    got = pp.intensity_normalize(torch.from_numpy(batch["image"])).numpy()
    want = np.asarray(jaug.intensity_normalize(jnp.asarray(batch["image"])))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
