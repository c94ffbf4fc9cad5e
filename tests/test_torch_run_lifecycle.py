"""The harness's run lifecycle against the JAX harness: the experiment
directory of every recipe equals ``train.get_save_path`` over its config
files; ``MetricWriter`` writes the JAX writer's records; the CLI saves
every epoch, resumes after the newest saved one with the best metric
restored (continuing as the uninterrupted run, loss for loss), logs
``loss/train`` and the meters at x = samples seen, writes a ``--profile``
trace, and ``--evaluate`` restores ``best`` and prints its meters."""

import importlib.util
import json
import os
import re

import pytest
import torch

from dgc_tpu.utils.logging import MetricWriter as JaxMetricWriter
from dgc_tpu_torch import configs
from dgc_tpu_torch import train as ttrain
from dgc_tpu_torch.utils.logging import MetricWriter, printr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def jax_train():
    """The JAX harness's ``train.py`` (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_harness_train", os.path.join(REPO, "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("recipe", sorted(configs.RECIPES))
def test_save_path_matches_jax(recipe, jax_train):
    files = configs.CONFIG_FILES[recipe]
    for f in files:
        assert os.path.isfile(os.path.join(REPO, f)), f
    assert ttrain.get_save_path(*files) == jax_train.get_save_path(*files)
    assert ttrain.get_save_path(*files, prefix="x") == \
        jax_train.get_save_path(*files, prefix="x")


def test_every_recipe_names_its_files():
    assert set(configs.CONFIG_FILES) == set(configs.RECIPES)


def test_metric_writer_matches_jax(tmp_path, capsys):
    records = [("loss/train", 2.5, 128), ("loss/train", 1.25, 6400),
               ("acc/test_top1", 10.15625, 6400), ("acc/test_top1_best",
                                                   12, 12800)]
    for cls, d in ((JaxMetricWriter, "jax"), (MetricWriter, "port")):
        w = cls(str(tmp_path / d))
        for r in records:
            w.add_scalar(*r)
        w.close()
    with open(tmp_path / "jax" / "metrics.jsonl") as a, \
            open(tmp_path / "port" / "metrics.jsonl") as b:
        assert a.read() == b.read()
    printr("only", "rank", 0)
    assert capsys.readouterr().out == "only rank 0\n"


def _run(argv, capsys):
    out = ttrain.main(argv)
    return out, capsys.readouterr().out


def _meter_lines(text):
    return re.findall(r"^\[acc/test_top[15]\] = .*$", text, re.M)


def test_resume_best_evaluate_and_logs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--world", "2", "--steps", "2",
              "--batch-size", "16", "--synthetic-size", "64"]
    whole, _ = _run(common + ["--epochs", "3", "--suffix", ".whole"], capsys)
    first, text = _run(common + ["--epochs", "2", "--profile"], capsys)
    assert "==> train from scratch" in text
    save = os.path.join("runs", "cifar.resnet20+dgc.wm5.np2")
    ckpt = os.path.join(save, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["best", "e0", "e1", "latest.json"]
    assert os.path.isfile(os.path.join(save, "profile", "trace.json"))
    with open(os.path.join(ckpt, "best", "meters.json")) as f:
        best = json.load(f)
    # a restart continues at epoch 2 with the best metric restored
    rest, text = _run(common + ["--epochs", "3"], capsys)
    assert f"[resumed] epoch 1, best {best['acc/test_top1_best']}" in text
    assert first + rest == whole
    summaries = [json.loads(line) for line in text.splitlines()
                 if line.startswith("{")]
    assert [s["epoch"] for s in summaries] == [2]
    # --evaluate restores best/ (the first epoch of the highest top-1)
    # and prints its meters
    with open(os.path.join(ckpt, "best", "meters.json")) as f:
        best = json.load(f)
    tops = []
    for e in range(3):
        with open(os.path.join(ckpt, f"e{e}", "meters.json")) as f:
            tops.append(json.load(f)["acc/test_top1"])
    assert best["epoch"] == tops.index(max(tops))
    out, text = _run(common + ["--evaluate"], capsys)
    assert out == []
    assert (f"[resumed] epoch {best['epoch']}, best "
            f"{best['acc/test_top1_best']}") in text
    assert _meter_lines(text) == [
        f"[acc/test_top1] = {best['acc/test_top1']:.2f}",
        f"[acc/test_top5] = {best['acc/test_top5']:.2f}"]
    # the log, over both runs: loss/train at samples seen (epoch e's
    # steps from e x 2 steps x 32 samples on), then the epoch's meters
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r for r in recs if r["tag"] == "loss/train"]
    assert [r["step"] for r in losses] == [32, 64, 96, 128, 160, 192]
    assert [r["value"] for r in losses] == whole
    tops = [r for r in recs if r["tag"] == "acc/test_top1_best"]
    assert [r["step"] for r in tops] == [64, 128, 192]
