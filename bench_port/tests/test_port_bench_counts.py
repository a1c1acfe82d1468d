"""The operation counts against the figures of PERF.md's kernel table, which
counted the kernels' own operands (mel lanes padded to 256, the spec := -1
stream projected like the conditional one)."""

from __future__ import annotations

import pytest

from bench_port import counts

FULL = counts.Shape(channels=512, layers=15, taps=3, n_mels=229, frames=640)


def test_k2_at_b8_is_130_37_tflop():
    flops = counts.k2_flops(FULL, 8, 200, True, cond_lanes=256, cond_streams=2)
    assert flops / 1e12 == pytest.approx(130.37, abs=0.005)
    assert counts.bound_s(flops, 0.0) * 1e3 == pytest.approx(131.82, abs=0.01)


def test_k3_and_k4_at_b16():
    assert counts.k3_flops(FULL, 16, cond_lanes=256) / 1e9 == pytest.approx(724.8, abs=0.05)
    assert counts.k4_flops(FULL, 16, cond_lanes=256) / 1e9 == pytest.approx(1369.0, abs=0.05)


def test_the_benchmark_counts_what_the_inputs_need():
    padded = counts.k2_flops(FULL, 8, 200, True, cond_lanes=256, cond_streams=2)
    needed = counts.k2_flops(FULL, 8, 200, True)
    assert needed < padded
    assert padded - needed == pytest.approx(8 * 640 * 15 * 2 * 1024 * (2 * 256 - 229))


def test_kernels_are_bound_by_operations_at_the_cells_shapes():
    for b in range(1, 9):
        assert counts.k2_flops(FULL, b, 200, True) / counts.PEAK_BF16_FLOPS > \
            counts.k2_bytes(FULL, b, 200) / counts.PEAK_BYTES_PER_S
    assert counts.k3_flops(FULL, 64) / counts.PEAK_BF16_FLOPS > \
        counts.k3_bytes(FULL, 64) / counts.PEAK_BYTES_PER_S
    assert counts.k4_flops(FULL, 64) / counts.PEAK_BF16_FLOPS > \
        counts.k4_bytes(FULL, 64) / counts.PEAK_BYTES_PER_S


def test_a_window_and_a_training_window():
    per_step_rows = 2 * 640 * (counts.stack_row_flops(FULL) + counts.head_row_flops(FULL))
    w = counts.window_flops(FULL, 200, True)
    assert w > 200 * per_step_rows
    assert w / 1e12 == pytest.approx(16.3, abs=0.1)
    assert counts.train_window_flops(FULL) == pytest.approx(3 * counts.forward_flops(FULL, 1))
