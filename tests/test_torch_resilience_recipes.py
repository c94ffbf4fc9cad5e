"""The resilience and two-tier recipes against the config files they flatten
(``configs/resilience.py`` with its checksum on, ``configs/dgc/twotier.py``)
stacked on the wm5 recipes, and what the trainer builds from them: guards,
the checksum, the node groups and the topology record."""

import os

import pytest
import torch

from dgc_tpu.utils.config import Config, configs
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer, get_save_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's keys of ``train.resilience`` (cohort surgery is not ported)
_RES_KEYS = ("enabled", "nonfinite_guard", "spike_window", "spike_factor",
             "watchdog_secs", "emergency_checkpoint", "flight_steps",
             "nonfinite_streak")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("recipe", ["resnet50_wm5_resilience",
                                    "resnet20_wm5_resilience",
                                    "resnet50_wm5_twotier",
                                    "resnet20_wm5_twotier"])
def test_recipes_match_the_config_files(recipe, monkeypatch):
    monkeypatch.chdir(REPO)
    Config.reset()
    try:
        Config.update_from_modules(*tconfigs.CONFIG_FILES[recipe])
        t = tconfigs.RECIPES[recipe]()
        base = tconfigs.RECIPES[recipe.rsplit("_", 1)[0]]()
        c = configs.train
        if recipe.endswith("resilience"):
            for k in _RES_KEYS:
                assert t.train.resilience[k] == c.resilience[k], k
            # the file leaves the checksum off; the recipe turns it on, as
            # --train.resilience.checksum True does
            assert c.resilience.checksum is False
            assert t.train.resilience.checksum is True
        else:
            assert t.train.num_local_workers == c.num_local_workers == 8
        assert t.train.compression == base.train.compression
        assert t.train.batch_size == c.batch_size
        assert t.dataset.image_size == configs.dataset.image_size
    finally:
        Config.reset()
    assert get_save_path(*tconfigs.CONFIG_FILES[recipe]).endswith(
        "+resilience" if "resilience" in recipe else "+dgc.wm5+twotier")


def test_trainers_build_what_the_recipes_ask():
    cfg = tconfigs.resnet20_wm5_resilience()
    cfg.dataset.synthetic_size = 32
    t = Trainer(cfg, LocalComm(2), "cpu")
    assert t.guards.nonfinite and t.guards.spike_window == 0
    assert t.setup.engine.checksum and t.compression.checksum
    assert t.state.guards is not None and t.num_local == 1
    cfg = tconfigs.resnet20_wm5_twotier()
    cfg.dataset.synthetic_size = 32
    with pytest.raises(ValueError, match="must divide"):
        Trainer(cfg, LocalComm(4), "cpu")
    cfg.train.num_local_workers = 2
    t = Trainer(cfg, LocalComm(4), "cpu")
    assert t.topology == {"process_count": 1, "world": 4,
                          "num_local_workers": 2}
    assert t.dist.num_nodes == 2 and t.dist.cross_comm.world == 2
    assert t.guards is None and not t.setup.engine.checksum
