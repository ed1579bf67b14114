"""The yardstick's counts against hand-reckoned shapes."""

import pytest

from asrbench import counts


def test_step_bytes_by_hand():
    # B 2, N 10, K1 2, R 5: state 2*10*12 = 240 read and written (480),
    # arcs 2*10*4 = 80, entries 40, senone map 40, rows 2*5*4 = 40,
    # frame index and counts 2*13 = 26
    assert counts.step_bytes(2, 10, 2, 5) == 480 + 80 + 40 + 40 + 40 + 26
    assert counts.step_ops(2, 10, 2) == 2 * 10 * 7


def test_word_end_bytes_by_hand():
    # B 1, Ex 4, k 2, M 1, narrow 2-gram, winner: exits 16 + 48,
    # candidates 2 * (21 + 8 + 64) = 186, atoms 24, winner 12 + 4
    assert counts.word_end_bytes(1, 4, 2, 1, 1, True) \
        == 16 + 48 + 186 + 24 + 16
    assert counts.word_end_bytes(1, 4, 2, 1, 0, False) \
        == 16 + 48 + 2 * 21 + 24
    assert counts.word_end_ops(3, 100, 10) == 3 * (100 + 140)


def test_scan_bytes_by_hand():
    # K 2, W 3, N 4, K1 2: outprob 2*3*4*4 = 96, seeds 24, tables
    # 2*5*4*4 = 160, starts 16, outputs 3*2*3*4 = 72
    assert counts.scan_bytes(2, 3, 4, 2) == 96 + 24 + 160 + 16 + 72
    assert counts.scan_ops(2, 3, 4, 2) == 2 * 3 * 4 * 11


def test_dnn_counts_by_hand():
    layers = [(6, 4), (4, 3)]
    assert counts.dnn_flops(10, layers) == 2 * 10 * (24 + 12)
    # bf16 weights and f32 biases once, f32 inputs and scores a frame
    assert counts.dnn_bytes(10, layers, 6, 5) \
        == (24 * 2 + 16) + (12 * 2 + 12) + 10 * (6 + 5) * 4


@pytest.mark.parametrize("flops,nbytes,want", [
    (989e12, 0.0, 1.0), (0.0, 3.35e12, 1.0), (989e9, 3.35e12, 1.0),
    (989e12 * 2, 3.35e12, 2.0)])
def test_least_time_is_the_larger_bound(flops, nbytes, want):
    assert counts.least_s(flops_bf16=flops, nbytes=nbytes) \
        == pytest.approx(want)
    assert counts.least_s(flops_f32=67e12) == pytest.approx(1.0)
