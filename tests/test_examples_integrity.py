"""Every shipped example config must parse and resolve its simulator."""

import glob
import json
import os

import pytest

from abcsmc_tpu.config import parse_config
from abcsmc_tpu.models.simulators import resolve_simulator

EXAMPLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"
)
CONFIGS = sorted(glob.glob(os.path.join(EXAMPLES, "*.json")))


def test_examples_exist():
    names = {c.rsplit("/", 1)[1] for c in CONFIGS}
    assert {"dice.json", "gaussian.json", "sir.json", "pseudo.json",
            "dengue_surrogate.json"} <= names


@pytest.mark.parametrize("path", CONFIGS)
def test_example_parses_and_binds(path):
    cfg = parse_config(path)
    assert cfg.npar >= 1 and cfg.nmet >= 1
    sim = resolve_simulator(cfg)
    assert sim is not None
    # set sizes and pred-prior sizes are consistent
    for t in range(min(cfg.num_smc_sets, 3)):
        assert cfg.smc_size_at(t) >= 1
        if not cfg.projection_mode:
            assert 1 <= cfg.pred_prior_size_at(t) <= cfg.smc_size_at(t)


def test_reference_configs_still_parse():
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    for path in (os.path.join(fixtures, "reference_quickstart.json"),
                 os.path.join(fixtures, "reference_pseudo.json"),
                 os.path.join(EXAMPLES, "dice.json"),
                 os.path.join(EXAMPLES, "pseudo.json")):
        cfg = parse_config(path)
        assert cfg.npar == 2
