"""Config parsing parity tests against the reference JSON schema
(src/AbcSmc.cpp:54-430), on in-repo fixtures rebuilt from the reference's
documented quick-start and projection examples."""

import json
import os

import pytest

from abcsmc_tpu.config import (
    ConfigError,
    DistType,
    FilterType,
    NoiseType,
    NumType,
    TransformFunc,
    parse_config,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
REFERENCE_JSON = os.path.join(FIXTURES, "reference_quickstart.json")
PSEUDO_JSON = os.path.join(FIXTURES, "reference_pseudo.json")


def test_reference_json_verbatim():
    cfg = parse_config(REFERENCE_JSON)
    assert cfg.num_smc_sets == 30
    assert cfg.smc_set_sizes == [300, 500, 500, 750, 1000]
    # last-value extension semantics (AbcSmc.h:44-52)
    assert cfg.smc_size_at(0) == 300
    assert cfg.smc_size_at(4) == 1000
    assert cfg.smc_size_at(29) == 1000
    # predictive_prior_fraction 0.5 applied per-set with extension
    assert cfg.pred_prior_size_at(0) == 150
    assert cfg.pred_prior_size_at(3) == 375
    assert cfg.pred_prior_size_at(10) == 500
    assert cfg.pls_training_fraction == 0.5
    assert cfg.noise == NoiseType.MULTIVARIATE
    assert cfg.filter == FilterType.PLS
    assert not cfg.projection_mode

    assert cfg.npar == 2
    p0 = cfg.parameters[0]
    assert p0.short_name == "ndice"
    assert p0.dist_type == DistType.UNIFORM
    assert p0.num_type == NumType.INT
    assert (p0.par1, p0.par2) == (1.0, 1000.0)

    assert cfg.nmet == 2
    assert cfg.metrics[0].short_name == "sum"
    assert cfg.metrics[0].value == 44
    assert cfg.metrics[1].value == pytest.approx(2.39925)


def test_pseudo_projection_mode():
    cfg = parse_config(PSEUDO_JSON)
    assert cfg.projection_mode
    assert cfg.num_smc_sets == 1
    # ndice PSEUDO par1=1 par2=5 step=1 -> 5 states; sides vals -> 5 states
    assert cfg.parameters[0].values == (1.0, 2.0, 3.0, 4.0, 5.0)
    assert cfg.parameters[1].values == (2.0, 4.0, 6.0, 8.0, 10.0)
    assert cfg.smc_set_sizes == [25]
    assert cfg.database_filename == "pseudo.sqlite"
    assert cfg.shared == "libdice.so"


def test_pred_prior_xor_required():
    base = json.load(open(REFERENCE_JSON))
    both = dict(base)
    both["predictive_prior_size"] = 10
    with pytest.raises(ConfigError):
        parse_config(both)
    neither = dict(base)
    del neither["predictive_prior_fraction"]
    with pytest.raises(ConfigError):
        parse_config(neither)


def test_training_fraction_bounds():
    base = json.load(open(REFERENCE_JSON))
    for bad in (0.0, 1.0, -0.5, 1.5):
        cfg = dict(base)
        cfg["pls_training_fraction"] = bad
        with pytest.raises(ConfigError):
            parse_config(cfg)


def test_pred_prior_size_exceeding_set_size_rejected():
    base = json.load(open(REFERENCE_JSON))
    cfg = dict(base)
    del cfg["predictive_prior_fraction"]
    cfg["predictive_prior_size"] = [400]  # > 300 at set 0
    with pytest.raises(ConfigError):
        parse_config(cfg)


def test_nonfinite_prior_bounds_rejected():
    # jsoncpp (strict JSON) cannot represent NaN/Infinity, so the reference
    # can never see a non-finite bound; Python's json.load accepts them -
    # they must be a coded config error, not a downstream NaN
    base = json.load(open(REFERENCE_JSON))
    for bad in (float("inf"), float("-inf"), float("nan")):
        cfg = json.loads(json.dumps(base))
        cfg["parameters"][0]["par2"] = None  # placeholder, patch below
        cfg["parameters"][0]["par2"] = bad
        with pytest.raises(ConfigError):
            parse_config(cfg)


def test_out_of_range_int_rejected():
    # jsoncpp asInt64 throws out-of-range; "num_samples": 1e30 must be a
    # config error, not an allocation failure twenty frames later
    base = json.load(open(REFERENCE_JSON))
    cfg = dict(base)
    cfg["num_samples"] = 1e30
    with pytest.raises(ConfigError):
        parse_config(cfg)


def test_empty_pseudo_grid_rejected():
    base = json.load(open(PSEUDO_JSON))
    # par1 > par2: reference loop body never runs -> zero states
    cfg = json.loads(json.dumps(base))
    cfg["parameters"][0].update(par1=5, par2=1)
    with pytest.raises(ConfigError):
        parse_config(cfg)
    # explicit vals list: empty or non-finite entries rejected
    cfg = json.loads(json.dumps(base))
    cfg["parameters"][1]["vals"] = []
    with pytest.raises(ConfigError):
        parse_config(cfg)


def test_zero_survivor_fraction_rejected():
    # fraction small enough to round to 0 survivors must fail at parse like
    # the explicit-size path does
    base = json.load(open(REFERENCE_JSON))
    cfg = dict(base)
    cfg["predictive_prior_fraction"] = 0.001  # 0.3 of 300 -> rounds to 0
    with pytest.raises(ConfigError):
        parse_config(cfg)


def test_projection_iteration_conflicts():
    base = json.load(open(PSEUDO_JSON))
    cfg = dict(base)
    cfg["smc_iterations"] = 3
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -202
    cfg = dict(base)
    cfg["num_samples"] = 7  # != 25 imputed
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -201


def test_row_block_parse_and_validation():
    base = json.load(open(REFERENCE_JSON))
    assert parse_config(dict(base)).row_block is None
    cfg = dict(base)
    cfg["row_block"] = 4096
    assert parse_config(cfg).row_block == 4096
    cfg["row_block"] = 0
    assert parse_config(cfg).row_block == 0
    # bool is an int subclass: "row_block": true must not parse as size 1
    for bad in (-1, 2.5, "lots", True, False):
        cfg["row_block"] = bad
        with pytest.raises(ConfigError):
            parse_config(cfg)


def test_propose_split_parse_and_validation():
    base = json.load(open(REFERENCE_JSON))
    assert parse_config(dict(base)).propose_split is None
    cfg = dict(base)
    for v in (True, False):
        cfg["propose_split"] = v
        assert parse_config(cfg).propose_split is v
    for bad in (1, 0, "auto", 2.5):
        cfg["propose_split"] = bad
        with pytest.raises(ConfigError):
            parse_config(cfg)


def test_unknown_types_rejected_with_codes():
    base = json.load(open(REFERENCE_JSON))
    cfg = json.loads(json.dumps(base))
    cfg["parameters"][0]["dist_type"] = "WIBBLE"
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -205

    cfg = json.loads(json.dumps(base))
    cfg["parameters"][0]["num_type"] = "WIBBLE"
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -206

    cfg = json.loads(json.dumps(base))
    cfg["metrics"][0]["num_type"] = "WIBBLE"
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -209

    cfg = json.loads(json.dumps(base))
    cfg["noise"] = "WIBBLE"
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -210

    # INT Gaussian unsupported (src/AbcSmc.cpp:239-243)
    cfg = json.loads(json.dumps(base))
    cfg["parameters"][0]["dist_type"] = "NORMAL"
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -206


def test_untransform_parsing():
    base = json.load(open(REFERENCE_JSON))
    cfg = json.loads(json.dumps(base))
    cfg["parameters"][0]["untransform"] = "POW_10"
    cfg["parameters"][1]["untransform"] = {
        "type": "LOGISTIC",
        "min": 0.1,
        "max": 0.9,
        "transformed_addend": ["number of dice"],
    }
    parsed = parse_config(cfg)
    u0 = parsed.parameters[0].untransform
    assert u0.func == TransformFunc.POW_10
    assert (u0.rescale_min, u0.rescale_max) == (0.0, 1.0)
    u1 = parsed.parameters[1].untransform
    assert u1.func == TransformFunc.LOGISTIC
    assert (u1.rescale_min, u1.rescale_max) == (0.1, 0.9)
    assert u1.transformed_addend_idx == (0,)
    assert parsed.has_untransforms

    cfg["parameters"][1]["untransform"] = {"type": "POW_10"}
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -207


def test_posterior_requires_database():
    cfg = {
        "parameters": [
            {"name": "p", "dist_type": "POSTERIOR", "num_type": "FLOAT",
             "par1": 0, "par2": 9},
        ],
        "metrics": [{"name": "m", "num_type": "FLOAT", "value": 1.0}],
    }
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert ei.value.code == -204
    cfg["posterior_database_filename"] = "post.sqlite"
    parsed = parse_config(cfg)
    assert parsed.parameters[0].posterior_size == 10
    assert parsed.projection_mode
    assert parsed.smc_set_sizes == [10]


def test_pseudo_step_grid_epsilon():
    # step grid is inclusive with EPSILON slack (src/AbcSmc.cpp:252-258)
    cfg = {
        "parameters": [
            {"name": "x", "dist_type": "PSEUDO", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0, "step": 0.25},
        ],
        "metrics": [{"name": "m", "num_type": "FLOAT", "value": 1.0}],
    }
    parsed = parse_config(cfg)
    assert parsed.parameters[0].values == (0.0, 0.25, 0.5, 0.75, 1.0)

    cfg["parameters"][0]["step"] = 0
    parsed = parse_config(cfg)
    assert parsed.parameters[0].values == (0.0,)


def test_default_iterations_from_size_arrays():
    # smc_iterations defaults to max(len(num_samples), len(pred_sizes))
    # (src/AbcSmc.cpp:133)
    base = json.load(open(REFERENCE_JSON))
    cfg = dict(base)
    del cfg["smc_iterations"]
    parsed = parse_config(cfg)
    assert parsed.num_smc_sets == 5  # len([300, 500, 500, 750, 1000])


def test_fitting_mode_requires_metric_values():
    """A metric without an observed 'value' in FITTING mode would NaN-poison
    every ranking distance (the 'survivors' would be the first K rows in
    insertion order, silently); the parser fails fast instead. Deliberate
    deviation from the reference, whose jsoncpp null.asDouble() would
    quietly use 0.0 (src/AbcSmc.cpp:142) - equally wrong statistically.
    Projection configs legitimately omit values: nothing is ranked there."""
    base = json.load(open(REFERENCE_JSON))
    cfg = json.loads(json.dumps(base))
    del cfg["metrics"][1]["value"]
    with pytest.raises(ConfigError) as ei:
        parse_config(cfg)
    assert "missing an observed 'value'" in str(ei.value)
    assert cfg["metrics"][1]["name"] in str(ei.value)

    # projection mode (the reference's pseudo example omits values): fine
    assert parse_config(PSEUDO_JSON).projection_mode


def test_uniform_reversed_bounds_is_coded_config_error():
    """par1 >= par2 on a UNIFORM prior raises ConfigError at construction,
    not a bare assert (the reference's Priors.h:69/95 assert disappears
    under NDEBUG, after which a reversed interval silently yields NaN
    importance weights)."""
    from abcsmc_tpu.models.parameters import ParameterSet

    base = json.load(open(REFERENCE_JSON))
    for num_type in ("INT", "FLOAT"):
        cfg = json.loads(json.dumps(base))
        cfg["parameters"][0]["num_type"] = num_type
        cfg["parameters"][0]["par1"] = 10
        cfg["parameters"][0]["par2"] = 10
        parsed = parse_config(cfg)  # schema-valid; bounds checked at build
        with pytest.raises(ConfigError):
            ParameterSet.from_specs(parsed.parameters)


def test_removed_weight_precision_key_is_refused():
    """The removed precision key of the old weight kernel: a config that
    still sets it is a coded error, never silently ignored."""
    base = json.load(open(REFERENCE_JSON))
    cfg = dict(base, weight_precision="high")
    with pytest.raises(ConfigError, match="weight_precision was removed") as e:
        parse_config(cfg)
    assert e.value.code == 1
