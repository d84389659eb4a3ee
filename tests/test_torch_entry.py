"""The port's entry dry run, med_tpu_torch/entry.py::dryrun_multichip, on
2 and 4 spawned gloo ranks on the CPU (med_tpu's __graft_entry__.py::
dryrun_multichip, tests/test_graft_entry.py): the DP+TP window step and
its eval step, the sharded snapshot's save, restore and resume, the
fold-parallel train and eval steps and the trial-parallel COG step, every
loss finite and every rank agreeing."""

import numpy as np
import pytest
import torch

from med_tpu_torch.entry import dryrun_multichip


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    out = dryrun_multichip(n, device="cpu")
    assert len(out) == n
    mesh = out[0]["mesh"]
    assert mesh == {"data": n // 2, "model": 2}
    assert out[0]["tp"] == ["fe.dense0.bias", "fe.dense0.weight", "fe.dense1.weight"]
    for key in ("train_loss", "eval_loss", "resumed_loss", "cog_loss"):
        vals = [r[key] for r in out]
        assert np.all(np.isfinite(vals)) and np.allclose(vals, vals[0], rtol=1e-6), key
    # ranks of one data row train the same folds; the rows train their own
    for r in out:
        assert len(r["fold_losses"]) == max(2, mesh["data"]) // mesh["data"]
    text = capsys.readouterr().out
    for line in ("window DP+TP", "sharded checkpoint save/load/resume ok",
                 "fold-parallel train+eval", "trial-parallel COG step"):
        assert f"dryrun_multichip({n}): {line}" in text


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", torch.device("cuda")])
def test_dryrun_multichip_runs_on_cuda_unless_asked_for_the_cpu(device):
    """Left to its default, or asked for the card in any spelling, the dry
    run wants CUDA and raises without it; it never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2, device=device)
