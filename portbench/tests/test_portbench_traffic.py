"""The seeded generators: the same inputs for the same seed, and the
length draws' clipping and medians."""
import numpy as np
import pytest

from portbench.lib import traffic

SEED = 2**31 + 4321   # past 32 signed bits: seeds may be that large


def test_calibration_ids_repeat_for_a_seed_and_differ_across_seeds():
    a = traffic.synthetic_calibration(151936, 8, 2048, SEED)
    b = traffic.synthetic_calibration(151936, 8, 2048, SEED)
    c = traffic.synthetic_calibration(151936, 8, 2048, SEED + 1)
    assert a.shape == (8, 2048) and a.dtype == np.int32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 151936


def test_calibration_ids_are_phrases_of_one_bank():
    ids = traffic.synthetic_calibration(1000, 4, 256, SEED, n_phrases=8, phrase_len=16)
    phrases = {tuple(row[i:i + 16]) for row in ids for i in range(0, 256, 16)}
    assert len(phrases) <= 8


@pytest.mark.parametrize("spec", [
    {"dist": "lognormal", "median": 640, "sigma": 0.5, "min": 256, "max": 1536},
    {"dist": "lognormal", "median": 384, "sigma": 0.6, "min": 128, "max": 1024},
    {"dist": "lognormal", "median": 1024, "sigma": 0.6, "min": 512, "max": 4096},
])
def test_lognormal_lengths_are_clipped_with_their_median(spec):
    x = traffic.stratified_lengths(spec, 1024, traffic.rng_for(SEED, 0))
    assert x.min() >= spec["min"] and x.max() <= spec["max"]
    assert abs(np.median(x) - spec["median"]) <= 1
    assert x.min() == spec["min"] or x.min() > spec["min"]


def test_uniform_lengths_cover_both_ends():
    x = traffic.stratified_lengths({"dist": "uniform", "min": 16, "max": 64}, 490,
                                   traffic.rng_for(SEED, 0))
    assert x.min() == 16 and x.max() == 64
    assert abs(np.median(x) - 40) <= 1


def test_seeds_draw_the_same_sizes_in_another_order():
    spec = {"dist": "lognormal", "median": 640, "sigma": 0.5, "min": 256, "max": 1536}
    a = traffic.stratified_lengths(spec, 512, traffic.rng_for(SEED, 0))
    b = traffic.stratified_lengths(spec, 512, traffic.rng_for(SEED + 9, 0))
    assert not np.array_equal(a, b) and np.array_equal(np.sort(a), np.sort(b))


def test_poisson_due_times_hold_the_rate():
    due = traffic.poisson_due(8.0, 30.0, traffic.rng_for(SEED, 4))
    assert np.all(np.diff(due) > 0)
    assert abs(len(due[due < 30.0]) - 240) <= 12
    again = traffic.poisson_due(8.0, 30.0, traffic.rng_for(SEED, 4))
    assert np.array_equal(due, again)


def test_request_stream_repeats_for_a_seed():
    mix = {"pool": 16, "prompt": {"dist": "uniform", "min": 4, "max": 9},
           "output": {"dist": "uniform", "min": 2, "max": 3}}
    a = traffic.RequestStream(mix, 100, traffic.rng_for(SEED, 2))
    b = traffic.RequestStream(mix, 100, traffic.rng_for(SEED, 2))
    for _ in range(40):
        (pa, oa), (pb, ob) = a.next(), b.next()
        assert pa == pb and oa == ob and 4 <= len(pa) <= 9 and 2 <= oa <= 3
