"""The port's host input pipeline (``dgc_tpu_torch/data/native.py``)
against the JAX package's: the C crop kernel (built here with gcc) and
its numpy version bitwise equal to the JAX ``crop_flip_normalize`` (its
C kernel where it builds, and its numpy path), the extreme offsets
included; the ``ArraySplit`` batches equal the JAX ``ArraySplit``'s for
one seed; the ``Prefetcher`` keeps order, forwards errors and releases
its thread on ``close()``; ``stage_ahead`` stages one item ahead. Also
the ``Trainer``'s input path: the prefetched batches equal the inline
ones, and only the steps asked for are prepared."""

import threading

import numpy as np
import pytest
import torch

from dgc_tpu.data import native as jnative
from dgc_tpu.data.datasets import ArraySplit as JaxArraySplit
from dgc_tpu_torch import configs
from dgc_tpu_torch.data import native
from dgc_tpu_torch.data.datasets import (CIFAR_MEAN, CIFAR_STD,
                                         IMAGENET_MEAN, IMAGENET_STD,
                                         ArraySplit)
from dgc_tpu_torch.data.sampler import epoch_batches
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards: these are many small CPU
    ops, no faster on several threads, and the files run beside other
    test workers, where several threads a worker oversubscribe the cores
    and slow every op by orders of magnitude. (A convolution's backward
    sums in another order at another thread count: each comparison here
    stays within one process, or sets one thread in its subprocesses.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(n, h=32, w=32, pad=4, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
    ys = rng.randint(0, 2 * pad + 1, size=n)
    xs = rng.randint(0, 2 * pad + 1, size=n)
    flips = rng.randint(0, 2, size=n).astype(np.uint8)
    return imgs, ys, xs, flips, pad


def _jax(imgs, ys, xs, flips, pad, mean, std, c_kernel):
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    if c_kernel:
        assert jnative.native_available()
        return jnative.crop_flip_normalize(imgs, ys, xs, flips, pad, mean,
                                           std)
    return jnative._numpy_path(imgs, ys, xs, flips, pad, scale, bias)


EXTREME = (np.full((4, 8, 8, 3), 200, np.uint8), np.array([0, 0, 8, 8]),
           np.array([0, 8, 0, 8]), np.array([0, 1, 0, 1], np.uint8), 4)


@pytest.mark.parametrize("case", ["random", "extreme", "imagenet", "empty"])
@pytest.mark.parametrize("c_kernel", [True, False])
def test_crop_kernel_and_plain_match_jax(case, c_kernel):
    mean, std = CIFAR_MEAN, CIFAR_STD
    if case == "random":
        args = _case(64, seed=1)
    elif case == "extreme":
        args = EXTREME
    elif case == "imagenet":
        args = _case(3, h=40, w=24, pad=6, seed=2)
        mean, std = IMAGENET_MEAN, IMAGENET_STD
    else:
        args = _case(0)
    want = _jax(*args, mean, std, c_kernel)
    got = native.crop_flip_normalize(*args, mean, std)
    plain = native.crop_flip_normalize_plain(*args, mean, std)
    assert got.dtype == plain.dtype == np.float32
    for out in (got, plain):
        assert out.shape == want.shape
        np.testing.assert_array_equal(out.view(np.uint32),
                                      want.view(np.uint32))


def test_crop_kernel_refuses_bad_offsets():
    imgs, ys, xs, flips, pad = _case(4)
    with pytest.raises(ValueError, match="offsets"):
        native.crop_flip_normalize(imgs, ys + 2 * pad, xs, flips, pad,
                                   CIFAR_MEAN, CIFAR_STD)
    with pytest.raises(ValueError, match="one offset pair"):
        native.crop_flip_normalize(imgs, ys[:2], xs, flips, pad,
                                   CIFAR_MEAN, CIFAR_STD)


def test_crop_kernel_without_a_compiler_raises(monkeypatch, tmp_path):
    """No silent fallback: with no gcc and no built library, the call
    raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="gcc not found"):
        native.crop_flip_normalize(*_case(2), CIFAR_MEAN, CIFAR_STD)


@pytest.mark.parametrize("train", [True, False])
def test_array_split_batches_match_jax(train):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (96, 32, 32, 3), dtype=np.uint8)
    labels = rng.randint(0, 10, 96)
    ours = ArraySplit(imgs, labels, CIFAR_MEAN, CIFAR_STD, train=train,
                      seed=5)
    theirs = JaxArraySplit(imgs, labels, CIFAR_MEAN, CIFAR_STD, train=train,
                           seed=5)
    order = np.random.RandomState(0).permutation(96)
    for b in range(3):
        idx = order[b * 32:(b + 1) * 32]
        (x, y), (jx, jy) = ours.get_batch(idx), theirs.get_batch(idx)
        np.testing.assert_array_equal(x.view(np.uint32), jx.view(np.uint32))
        np.testing.assert_array_equal(y, jy)


class _Split:
    """``get_batch(i)`` -> ``(i, i)``; raises at ``fail``; counts calls
    and can block until released."""

    def __init__(self, fail=None, gate=None):
        self.fail, self.gate, self.calls = fail, gate, 0

    def get_batch(self, idx):
        self.calls += 1
        if self.gate is not None:
            self.gate.wait(timeout=10)
        if int(idx) == self.fail:
            raise RuntimeError("boom")
        return np.full((2,), int(idx)), np.full((2,), int(idx))


def test_prefetcher_keeps_order_and_forwards_errors():
    with native.Prefetcher(_Split(), iter(np.arange(7)), depth=2) as pf:
        assert [int(x[0]) for x, _ in pf] == list(range(7))
    with native.Prefetcher(_Split(fail=3), iter(np.arange(6))) as pf:
        it = iter(pf)
        assert [int(next(it)[0][0]) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(RuntimeError, match="boom"):
            next(it)


def test_prefetcher_close_releases_its_thread():
    """Iteration abandoned with the queue full, and with the thread
    blocked inside ``get_batch``: ``close()`` ends the thread either
    way."""
    pf = native.Prefetcher(_Split(), iter(np.arange(100)), depth=2)
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()
    gate = threading.Event()
    pf = native.Prefetcher(_Split(gate=gate), iter(np.arange(100)))
    threading.Timer(0.2, gate.set).start()
    pf.close(timeout=10)
    assert not pf._thread.is_alive()


def test_stage_ahead_stages_one_ahead():
    staged = []

    def stage(i):
        staged.append(i)
        return i * 10
    got = []
    for out in native.stage_ahead(iter(range(4)), stage, depth=1):
        got.append((out, list(staged)))
    assert got == [(0, [0, 1]), (10, [0, 1, 2]), (20, [0, 1, 2, 3]),
                   (30, [0, 1, 2, 3])]


def test_trainer_inputs_equal_inline_batches():
    """The ``Trainer``'s prefetched inputs are its inline batches element
    for element, and a capped epoch prepares only its steps' batches
    (an augmenting split draws as often as inline)."""
    cfg = configs.resnet20_wm5()
    cfg.train.batch_size, cfg.dataset.synthetic_size = 4, 64
    trainer = Trainer(cfg, LocalComm(2), device="cpu")
    split = trainer.dataset["train"]

    class Counting:
        calls = 0

        def __len__(self):
            return len(split)

        def get_batch(self, idx):
            self.calls += 1
            return split.get_batch(idx)
    want = [trainer._batches(idx) for idx in epoch_batches(
        len(split), trainer.global_batch, 3, seed=trainer.seed)][:3]
    trainer.dataset["train"] = counting = Counting()
    got = list(trainer.epoch_inputs(3, steps=3))
    assert counting.calls == 3 and len(got) == 3
    for (xs, ys), (wx, wy) in zip(got, want):
        for a, b in zip(xs + ys, wx + wy):
            assert a.dtype == b.dtype and torch.equal(a, b)
