"""The ImageNet folder reader (``data.datasets.ImageFolderSplit``) against
the JAX package's ``_ImageFolderSplit``, on a class-per-directory folder
the test writes with PIL (PNGs of odd sizes, wider and taller than the
crop, and smaller): the sample list, and batches bitwise with one decode
worker (inline) and with a pool of two spawned processes, for the train
split (random crops and flips from per-image seeds) and the val split
(resize and centre crop). The batches do not depend on the worker count:
the per-image seeds come from one draw per batch. Also the
``Trainer``'s inputs from such a folder."""

import os

import numpy as np
import pytest
import torch

from dgc_tpu.data.datasets import _ImageFolderSplit as JaxFolderSplit
from dgc_tpu_torch.data import datasets as tdata

#: (width, height) of each class's images
SIZES = ((40, 30), (25, 57), (64, 64), (17, 20), (90, 33))


def image_folder(root, classes=3, per_class=3, seed=0):
    """``root/{train,val}/c<i>/<j>.png``: random RGB images of odd
    sizes."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        for c in range(classes):
            d = os.path.join(root, split, f"c{c}")
            os.makedirs(d)
            for j in range(per_class):
                w, h = SIZES[(c * per_class + j) % len(SIZES)]
                Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
                    np.uint8)).save(os.path.join(d, f"{j}.png"))
    return str(root)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return image_folder(tmp_path_factory.mktemp("imagenet"))


@pytest.mark.parametrize("split,train", [("train", True), ("val", False)])
def test_folder_batches_match_jax(folder, split, train):
    root = os.path.join(folder, split)
    j = JaxFolderSplit(root, 24, train=train, seed=3, workers=1)
    one = tdata.ImageFolderSplit(root, 24, train=train, seed=3, workers=1)
    two = tdata.ImageFolderSplit(root, 24, train=train, seed=3, workers=2)
    try:
        assert one.samples == j.samples and len(one) == 9
        assert one.class_to_idx == j.class_to_idx
        for idx in (np.array([4, 0, 8, 1]), np.arange(9)[::-1]):
            want = j.get_batch(idx)
            for got in (one.get_batch(idx), two.get_batch(idx)):
                assert got[0].shape == (len(idx), 24, 24, 3)
                assert got[0].dtype == np.float32
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
        assert two._pool is not None
    finally:
        two.close()


def test_imagenet_reads_the_folders(folder):
    """``ImageNet`` takes the folders when ``train/`` and ``val/`` exist;
    without them and without the fallback it raises."""
    ds = tdata.ImageNet(folder, 3, 32)
    assert isinstance(ds["train"], tdata.ImageFolderSplit)
    assert ds["train"].train and not ds["test"].train
    assert len(ds["test"]) == 9
    with pytest.raises(FileNotFoundError):
        tdata.ImageNet(os.path.join(folder, "absent"),
                       synthetic_fallback=False)


def test_trainer_trains_from_a_folder(folder, monkeypatch):
    """The harness's input path over the folder reader: a narrow VGG, two
    workers, one step, and the evaluation over the val split."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    monkeypatch.setattr(tdata.ImageFolderSplit, "MAX_DEFAULT_WORKERS", 1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = configs.vgg16_bn_wm5()
        cfg.dataset.update(root=folder, num_classes=3, image_size=28)
        cfg.model.update(num_classes=3, cfg=(4, "M", 8, "M"))
        cfg.train.batch_size = 2
        t = Trainer(cfg, LocalComm(2), device="cpu")
        xs, ys = next(iter(t.epoch_inputs(0, 1)))
        assert xs[0].shape == (2, 3, 28, 28) and ys[1].dtype == torch.int64
        losses = t.run_epoch(5, 1)
        assert len(losses) == 1 and torch.isfinite(losses[0])
        meters = t.evaluate()
        assert 0.0 <= meters["acc/test_top1"] <= 100.0
    finally:
        torch.set_num_threads(n)


def test_a_named_root_without_folders_stops_the_run(tmp_path, monkeypatch):
    """The recipe's ``dataset.synthetic_fallback`` reaches ``ImageNet``:
    False, and a root without ``train/`` and ``val/`` raises in the
    ``Trainer``; ``--data-root`` sets it so, before any model is built."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch import train as ttrain
    from dgc_tpu_torch.parallel.comm import LocalComm
    missing = str(tmp_path / "absent")
    cfg = configs.vgg16_bn_wm5()
    assert cfg.dataset.synthetic_fallback is True
    cfg.dataset.update(root=missing, synthetic_fallback=False)
    with pytest.raises(FileNotFoundError, match="absent"):
        ttrain.Trainer(cfg, LocalComm(1), device="cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="absent"):
        ttrain.main(["--config", "vgg16_bn_wm5", "--device", "cpu",
                     "--data-root", missing])
