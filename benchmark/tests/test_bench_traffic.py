"""The inputs drawn from the seed: the same for the same seed, other for
another; every seed sends the same work."""

from __future__ import annotations

from collections import Counter

import numpy as np

from benchmark import inputs
from benchmark.reference import adm, flow
from benchmark.tests.tiny import traffic_file

SERVE = traffic_file("serve-regions-c4")
BIG = 2**31 + 11


def test_schedule_same_seed_same_order():
    assert inputs.region_schedule(SERVE, BIG, 5) == inputs.region_schedule(SERVE, BIG, 5)


def test_schedule_other_seed_other_order():
    assert inputs.region_schedule(SERVE, BIG, 5) != inputs.region_schedule(SERVE, BIG + 1, 5)


def test_every_block_holds_the_same_sizes():
    n = SERVE["block"]
    for seed in (1, BIG):
        sched = inputs.region_schedule(SERVE, seed, 4)
        for b in range(4):
            assert sorted(sched[b * n:(b + 1) * n]) == list(range(n))


def test_sizes_span_the_range_and_stay_fixed():
    sizes = inputs.region_sizes(SERVE)
    assert sizes == inputs.region_sizes(SERVE)
    assert all(SERVE["min_px"] <= v <= SERVE["max_px"] for hw in sizes for v in hw)
    tiles = [flow.tiles_of(h, w, 256, 32) for h, w in sizes]
    assert min(tiles) >= 1 and max(tiles) <= 25


def test_region_pixels_follow_the_seed():
    a = inputs.region_image(40, 30, np.random.default_rng(BIG))
    b = inputs.region_image(40, 30, np.random.default_rng(BIG))
    c = inputs.region_image(40, 30, np.random.default_rng(BIG + 1))
    assert a.shape == (40, 30, 3) and a.dtype == np.uint8
    assert (a == b).all() and (a != c).any()


def test_weights_follow_the_seed():
    shapes = [("a.weight", (4, 3, 3, 3)), ("a.bias", (4,)), ("n.weight", (4,)), ("out.2.weight", (3, 4, 3, 3))]
    w1, w2, w3 = (inputs.make_weights(shapes, s, "cpu", adm.zeroed) for s in (BIG, BIG, BIG + 1))
    assert all((w1[k] == w2[k]).all() for k in w1)
    assert any((w1[k] != w3[k]).any() for k in w1)
    assert abs(float(w1["n.weight"].mean()) - 1.0) < 0.1
    assert float(w1["out.2.weight"].std()) < 0.1


def test_tile_tree_is_written_once_and_reread(tmp_path):
    spec = {"n_train": 3, "n_val": 1, "n_test": 1, "size": 16, "seed": 0}
    root = inputs.tile_tree(spec, tmp_path)
    assert len(inputs.read_split(root, "train")) == 3
    stamp = (root / "metadata.csv").stat().st_mtime_ns
    assert inputs.tile_tree(spec, tmp_path) == root
    assert (root / "metadata.csv").stat().st_mtime_ns == stamp
    he = inputs.decode_png(root / "train" / inputs.read_split(root, "train")[0][0])
    assert he.shape == (16, 16, 3)
    assert Counter(len(inputs.read_split(root, s)) for s in ("val", "test")) == Counter({1: 2})


def test_weights_zero_nothing_by_default():
    shapes = [("out.2.weight", (16, 2, 3, 3)), ("blocks.0.proj_out.weight", (64, 4))]
    plain, adm_init = inputs.make_weights(shapes, BIG, "cpu"), inputs.make_weights(shapes, BIG, "cpu", adm.zeroed)
    for k, _ in shapes:
        assert float(plain[k].std()) > 0.1 > float(adm_init[k].std())
