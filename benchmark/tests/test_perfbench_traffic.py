"""Each driver makes the same inputs from the same seed, other inputs from
another, and every seed the same set of lengths (a seed orders them)."""

import numpy as np
import pytest
import torch

from conftest import SEED, tiny_run


def _inputs(cell, seed):
    run = tiny_run(cell, seed)
    d = run.driver
    if cell == "cog.pixels":
        d._inputs()
        data = [d.pool, d.kin, np.array(d.requests)]
    else:
        d._inputs()
        data = ([np.concatenate([t["images"].ravel(), t["kinematics"].ravel()])
                 for t in d.trials] if cell == "cog.train" else [d.images, d.labels])
    return d, {k: v.clone() for k, v in d.weights.items()}, data


@pytest.mark.parametrize("cell", ["cog.train", "resnet50.finetune", "cog.pixels"])
def test_inputs_follow_the_seed(cell):
    d1, w1, x1 = _inputs(cell, SEED)
    d2, w2, x2 = _inputs(cell, SEED)
    _, w3, x3 = _inputs(cell, SEED + 1)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert all(np.array_equal(a, b) for a, b in zip(x1, x2))
    assert not all(torch.equal(w1[k], w3[k]) for k in w1)
    assert not all(a.shape == b.shape and np.array_equal(a, b) for a, b in zip(x1, x3))


@pytest.mark.parametrize("cell", ["cog.train", "cog.pixels"])
def test_every_seed_draws_the_same_lengths(cell):
    def lengths(seed):
        d, _, _ = _inputs(cell, seed)
        if cell == "cog.train":
            return sorted(len(t["labels"]) for t in d.trials), [len(t["labels"]) for t in d.trials]
        return sorted(L for L, _ in d.requests), [L for L, _ in d.requests]

    (s1, o1), (s2, o2) = lengths(SEED), lengths(7)
    assert s1 == s2 and o1 != o2


def test_finetune_draws_follow_the_seed():
    """The feed's augmentation draws are the program's ``draw_augment``
    from a generator seeded by the seed: the same seed, the same draws."""
    from med_tpu_torch.cli.resnet_finetune import _batches, draw_augment

    def draws(seed):
        d = tiny_run("resnet50.finetune", seed).driver
        d._inputs()
        d._batches, d._draw = _batches, draw_augment
        return next(d._feed())[3]

    da, db, dc = draws(SEED), draws(SEED), draws(SEED + 1)
    assert torch.equal(da["angles"], db["angles"]) and torch.equal(da["flip"], db["flip"])
    assert not torch.equal(da["angles"], dc["angles"])


@pytest.mark.parametrize("cell,key", [("cog.pixels", "arrivals"), ("cog.train", "frames.law"),
                                      ("resnet50.finetune", "order")])
def test_a_traffic_parameter_the_driver_does_not_read_is_refused(cell, key):
    from conftest import tiny
    from core.run import Run

    s, w, cfg, tr = tiny(cell)
    outer, _, inner = key.partition(".")
    if inner:
        tr[outer] = dict(tr[outer], **{inner: "log_uniform"})
    else:
        tr[outer] = "poisson"
    with pytest.raises(SystemExit, match="does not read"):
        Run(s, w, SEED, torch.device("cpu"), False, config=cfg, traffic=tr, log=lambda m: None)
