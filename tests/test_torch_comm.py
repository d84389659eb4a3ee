"""The port's collectives (med_tpu_torch/parallel/comm.py) on 2 and 4
spawned gloo ranks, each against numpy: the all-reduce (its two backward
rules), the distributed causal shift at offsets within a shard, across
shards and past the sequence (med_tpu's tests/test_seqpar.py::
test_seq_shift_right), the left halo with a fill row including the
multi-hop widths (tests/test_sp_cog.py::test_halo_left_multi_hop), the
gather, and each one's gradient: a cotangent goes back to the rank whose
rows made it. One group a world size serves every check (a module-scoped
fixture)."""

import os

import numpy as np
import pytest
import torch

from med_tpu_torch.parallel import launch
from torch_rank_bodies import comm_suite

T, C = 64, 3
OFFSETS = [0, 1, 7, 16, 17, 33, 40, 64, 70]
WIDTHS = [5, 16, 21, 40]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    n = request.param
    return n, launch.spawn(comm_suite, n, str(tmp_path_factory.mktemp(f"comm{n}")),
                           args=(T, C, OFFSETS, WIDTHS), device="cpu")


def _globals():
    rng = np.random.default_rng(0)
    return rng.normal(size=(T, C)).astype(np.float32), rng.normal(size=(T, C)).astype(np.float32)


def _cat(out, key, part):
    return np.concatenate([r[key][part] for r in out])


def test_psum_sums_and_its_backward_rules(ranks):
    n, out = ranks
    x, w = _globals()
    S = T // n
    total = x.reshape(n, S, C).sum(0)
    for r in out:
        np.testing.assert_allclose(r["psum_identity"][0], total, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["psum_sum"][0], total, rtol=1e-6, atol=1e-6)
    # identity: each rank's own cotangent; sum: every rank's
    np.testing.assert_array_equal(_cat(out, "psum_identity", 1), w)
    np.testing.assert_allclose(_cat(out, "psum_sum", 1),
                               np.tile(w.reshape(n, S, C).sum(0), (n, 1)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("offset", OFFSETS)
def test_seq_shift_right_and_its_gradient(ranks, offset):
    _, out = ranks
    x, w = _globals()
    want = np.zeros_like(x)
    grad = np.zeros_like(w)           # the opposite shift
    if offset < T:
        want[offset:] = x[:T - offset]
        grad[:T - offset] = w[offset:]
    np.testing.assert_array_equal(_cat(out, f"shift_{offset}", 0), want)
    np.testing.assert_array_equal(_cat(out, f"shift_{offset}", 1), grad)


@pytest.mark.parametrize("width", WIDTHS)
def test_halo_left_with_fill_row_and_multi_hop(ranks, width):
    n, out = ranks
    x, _ = _globals()
    S = T // n
    fill = np.random.default_rng(0)
    fill.normal(size=(T, C)), fill.normal(size=(T, C))
    fill_row = fill.normal(size=C).astype(np.float32)
    grad = np.zeros_like(x)
    for i, r in enumerate(out):
        rows = i * S - width + np.arange(width)
        want = np.where((rows >= 0)[:, None], x[np.clip(rows, 0, None)], fill_row)
        np.testing.assert_array_equal(r[f"halo_{width}"][0], want)
        wh = np.random.default_rng(100 + i).normal(size=(width, C)).astype(np.float32)
        np.add.at(grad, rows[rows >= 0], wh[rows >= 0])
    np.testing.assert_allclose(_cat(out, f"halo_{width}", 1), grad, rtol=1e-6, atol=1e-6)


def test_all_gather_and_fetch_past_the_group(ranks):
    _, out = ranks
    x, w = _globals()
    for r in out:
        np.testing.assert_array_equal(r["gather"][0], x)
        np.testing.assert_array_equal(r["far"], np.zeros_like(r["far"]))
    np.testing.assert_array_equal(_cat(out, "gather", 1), w)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_spawn_wants_cuda_unless_asked_for_the_cpu(tmp_path):
    """Left to its default device, ``spawn`` runs its ranks on CUDA and
    raises without a GPU before it starts any; it never falls back to the
    CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(comm_suite, 2, str(tmp_path / "ranks"), args=(T, C, OFFSETS, WIDTHS))
    assert not os.path.exists(tmp_path / "ranks")
