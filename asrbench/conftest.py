"""Tests of the benchmark (`python -m pytest asrbench/`): CPU tests at a
tiny size, and tests marked `cuda` that need the card and skip without
one."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA); skips without one")


#: a configuration's sizes cut to what a CPU test runs in seconds
TINY_CONFIG = dict(feat_dim=6, input_size=66, hidden_size=32,
                   num_hidden_layers=2, num_phones=12, num_senones=35,
                   vocab_size=24)
TINY_TRAFFIC = dict(pool_batches=200, check_within=1, check_batches=1,
                    word_counts=[2, 3])


def tiny_cell(workload: str):
    """(config, traffic) of a cell of BENCHMARK.json at a tiny size."""
    from asrbench import harness
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    cfg = harness.load_json(harness.HERE / "configs"
                            / f"{cell['config']}.json")
    cfg.update(TINY_CONFIG)
    cfg["search"]["trellis_topm"] = 6
    traffic = harness.load_json(harness.HERE / "traffic"
                                / f"{cell['traffic']}.json")
    traffic.update(TINY_TRAFFIC, batch=min(int(traffic["batch"]), 2))
    return cfg, traffic


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
