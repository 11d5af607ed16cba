"""SharedLibSimulator: a real compiled C shared object through the full SMC
loop (the reference's `shared` binding, AbcSim.h:96-114)."""

import os
import subprocess

import numpy as np
import pytest

from abcsmc_tpu.engine import AbcSmc
from abcsmc_tpu.errors import SimulatorError
from abcsmc_tpu.models.simulators import SharedLibSimulator


@pytest.fixture(scope="module")
def libdice(tmp_path_factory):
    out = tmp_path_factory.mktemp("solib") / "libdice.so"
    subprocess.run(
        ["gcc", "-O2", "-shared", "-fPIC", "-o", str(out),
         "examples/dice_sim.c", "-lm"],
        check=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    return str(out)


def test_shared_lib_run_batch(libdice):
    sim = SharedLibSimulator(libdice, nmet=2)
    params = np.array([[10.0, 6.0], [1.0, 6.0], [100.0, 2.0]])
    mets = sim.run_batch(params, np.array([1, 2, 3]), np.array([0, 1, 2]))
    assert mets.shape == (3, 2)
    assert 10 <= mets[0, 0] <= 60          # 10 dice of 6
    assert mets[1, 1] == 0.0               # single die -> sd 0
    assert 100 <= mets[2, 0] <= 200        # 100 coins
    # deterministic replay from the seed
    again = sim.run_batch(params, np.array([1, 2, 3]), np.array([0, 1, 2]))
    np.testing.assert_array_equal(mets, again)


def test_shared_lib_full_fit(libdice, tmp_path):
    cfg = {
        "smc_iterations": 2,
        "num_samples": 150,
        "predictive_prior_size": 20,
        "shared": libdice,
        "database_filename": str(tmp_path / "so.sqlite"),
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }
    abc = AbcSmc(cfg)  # simulator bound from config "shared"
    assert isinstance(abc.simulator, SharedLibSimulator)
    abc.run(seed=6)
    pars, _ = abc.posterior()
    assert pars.shape == (20, 2)
    # tightened vs the U(1,50) prior
    assert pars[:, 1].std() < 15


REF_ABI_SRC = r"""
// Mock REFERENCE-ABI simulator: the unmangled-name / C++-type `simulator`
// symbol the reference dlopens (/root/reference/include/AbcSmc/AbcSim.h:55-114).
#include <vector>
extern "C" std::vector<double> simulator(std::vector<double> pars,
                                         const unsigned long seed,
                                         const unsigned long serial) {
    if (pars[0] < 0) return {};  // failure mode: empty metric vector
    // deterministic in (pars, seed): xorshift64 noise
    unsigned long long x = seed ? seed : 88172645463325252ULL;
    x ^= x << 13; x ^= x >> 7; x ^= x << 17;
    double noise = (double)(x % 1000) / 1000.0;
    return { pars[0] * 2.0 + pars[1] + noise, pars[0] - pars[1] };
}
"""


@pytest.fixture(scope="module")
def libref(tmp_path_factory):
    d = tmp_path_factory.mktemp("refso")
    src = d / "ref_sim.cpp"
    src.write_text(REF_ABI_SRC)
    out = d / "libref.so"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", str(out), str(src)],
        check=True,
    )
    return str(out)


def test_reference_abi_shim_run_batch(libref):
    """A reference-ABI .so (C++ vector signature) runs
    unmodified through the compiled-on-demand adapter shim."""
    sim = SharedLibSimulator(libref, nmet=2)
    assert sim._shim is not None          # went through the reference shim
    params = np.array([[10.0, 6.0], [3.0, 1.0]])
    mets = sim.run_batch(params, np.array([7, 9]), np.array([0, 1]))
    assert mets.shape == (2, 2)
    np.testing.assert_allclose(mets[:, 1], [4.0, 2.0])
    assert 26.0 <= mets[0, 0] <= 27.0     # 2*10 + 6 + noise in [0, 1)
    # deterministic replay from the stored seed
    again = sim.run_batch(params, np.array([7, 9]), np.array([0, 1]))
    np.testing.assert_array_equal(mets, again)


def test_reference_abi_shim_metric_count_mismatch(libref):
    sim = SharedLibSimulator(libref, nmet=5)   # mock returns 2 metrics
    with pytest.raises(SimulatorError, match="wrong number of metrics"):
        sim.run_batch(np.array([[1.0, 2.0]]), np.array([1]), np.array([0]))
    # an EMPTY metric vector (rc == exactly 1000) is also a count mismatch
    sim2 = SharedLibSimulator(libref, nmet=2)
    with pytest.raises(SimulatorError, match="received 0"):
        sim2.run_batch(np.array([[-1.0, 2.0]]), np.array([1]), np.array([0]))


def test_reference_abi_shim_simulate_flow(libref, tmp_path):
    """Config `shared` binding + --simulate semantics over a reference-ABI
    binary (the reference workflow, src/AbcSmc.cpp:967-1039)."""
    cfg = {
        "smc_iterations": 1,
        "num_samples": 12,
        "predictive_prior_size": 4,
        "shared": libref,
        "database_filename": str(tmp_path / "ref.sqlite"),
        "parameters": [
            {"name": "a", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 10.0},
            {"name": "b", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 10.0},
        ],
        "metrics": [
            {"name": "m0", "num_type": "FLOAT", "value": 12.0},
            {"name": "m1", "num_type": "FLOAT", "value": 1.0},
        ],
    }
    abc = AbcSmc(cfg)
    assert isinstance(abc.simulator, SharedLibSimulator)
    abc.process_database(seed=3)
    abc.simulate_next_particles(n=-1)
    gens = abc.storage.read_generations()
    assert gens[0].complete
    # metrics actually came from the C++ simulator
    pars, mets = gens[0].params, gens[0].metrics
    np.testing.assert_allclose(mets[:, 1], pars[:, 0] - pars[:, 1],
                               rtol=1e-12)


def test_shared_lib_missing_symbol(tmp_path):
    src = tmp_path / "empty.c"
    src.write_text("int unrelated(void) { return 0; }\n")
    out = tmp_path / "empty.so"
    subprocess.run(
        ["gcc", "-shared", "-fPIC", "-o", str(out), str(src)], check=True
    )
    with pytest.raises(SimulatorError):
        SharedLibSimulator(str(out), nmet=2)
