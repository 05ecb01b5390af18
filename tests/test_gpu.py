"""Kernel parity on the card: each device kernel of the main path against
its in-repo reference (chip_smoke.py phase 2 at moderate widths).  Skips
unless JAX's default backend is a GPU; on the card run
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.gpu


def test_folded_em_matches_float64_cpu():
    cs.em_parity(cs.soak_features(40, seed=7))


def test_xla_poa_aligner_matches_host_engine():
    cs.aligner_parity(cs.aligner_cases(16, 300, 8, seed=5))


def test_fused_build_matches_host_engine():
    import bench
    wins = bench.make_window_payloads(8, np.random.default_rng(1))
    cs.fused_parity([w.sequences for w in wins])


def test_misscore_kernel_matches_host_dp():
    cs.nw_parity(cs.nw_pairs(16, 300, 480, seed=9), 512)


def test_forest_matches_float64_cpu():
    cs.forest_parity(cs.forest_features(1024, seed=2))
