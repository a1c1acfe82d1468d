"""The traffic generator repeats exactly for a seed, and gives every seed the
same set of sizes in another order."""

from __future__ import annotations

import numpy as np
import torch

from bench_port import inputs
from bench_port.runners.train import Runner as TrainRunner

from .conftest import HERE, tiny_run
from bench_port import run as bench

MIX = bench.load_json(HERE / "traffic" / "transcribe_long.json")
BIG = 2 ** 40 + 12345   # seeds run past 32 bits


def test_recording_lengths_are_the_log_uniform_mid_quantiles():
    secs = inputs.recording_seconds(MIX)
    assert len(secs) == MIX["recordings"]["count"]
    assert MIX["recordings"]["seconds_min"] < min(secs) < max(secs) < MIX["recordings"]["seconds_max"]
    ratios = np.diff(np.log(secs))
    assert np.allclose(ratios, ratios[0])


def test_order_repeats_for_a_seed_and_permutes_the_same_set():
    a = inputs.recording_order(MIX, BIG, cycles=3)
    assert a == inputs.recording_order(MIX, BIG, cycles=3)
    b = inputs.recording_order(MIX, BIG + 1, cycles=3)
    assert a != b
    n = MIX["recordings"]["count"]
    for order in (a, b):
        for c in range(3):
            assert sorted(order[c * n:(c + 1) * n]) == list(range(n))


def test_recordings_repeat_for_a_seed():
    mix = dict(MIX, recordings={"seconds_min": 2.0, "seconds_max": 5.0, "count": 3})
    one, two = inputs.recordings(mix, BIG, 16000), inputs.recordings(mix, BIG, 16000)
    other = inputs.recordings(mix, BIG + 7, 16000)
    assert all(np.array_equal(x, y) for x, y in zip(one, two))
    assert [len(x) for x in one] == [len(x) for x in other]
    assert not all(np.array_equal(x, y) for x, y in zip(one, other))


def test_chord_audio_is_the_ports_chord_audio():
    from diffroll_tpu_torch.profile_serve import chord_audio

    for seconds, seed in ((3.0, 5), (4.7, 11), (1.2, 0)):
        assert np.array_equal(inputs.chord_audio(seconds, 16000, seed),
                              chord_audio(seconds, 16000, seed))


def test_torch_seeds_fit_a_generator_and_differ_by_stream():
    s = {inputs.torch_seed(BIG, k) for k in range(5)}
    assert len(s) == 5 and all(0 <= v < 2 ** 63 for v in s)
    torch.Generator().manual_seed(max(s))


def test_training_pool_repeats_for_a_seed():
    pools = []
    for seed in (BIG, BIG, BIG + 1):
        pools.append(TrainRunner(tiny_run("diffroll-train", seed)).make_pool())
    for key in ("audio", "frame", "t", "noise"):
        assert all(torch.equal(x[key], y[key]) for x, y in zip(pools[0], pools[1]))
        assert not torch.equal(pools[0][0][key], pools[2][0][key]) or key == "t"
    rows = torch.cat([b["noise"] for b in pools[0]])
    assert len({tuple(r.flatten()[:8].tolist()) for r in rows}) == rows.shape[0]
