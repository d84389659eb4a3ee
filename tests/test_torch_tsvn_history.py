"""TransSVNet's training trajectory in the port against med_tpu's: both
packages' ``train_frame_fold`` for 3 epochs on two synthetic folds, from
the same weights over the same frozen TeCNo (TransSVNet draws no dropout,
and the frozen TeCNo runs in eval mode, so no masks are needed), on the
CPU at a small width, beside the port's fold in float64 throughout (the
frozen TeCNo's output cast up) as the reference.

The port runs TransSVNet's closing LayerNorm, its FFN and its decoder in
float64, med_tpu in float32. Its LayerNorms act over 2 classes and drive
each frame's output to one of two values, so a loss moves in steps of a
frame's flip, and a float32 gradient (~2 digits there) flips some frames
a float64 one does not. Measured: med_tpu within 1.1e-1 of the float64
fold's losses, the port within 2.4e-2, the best epochs all equal. Held:
the best epoch equal in all three; each epoch's losses within
JAX_NOISE = 0.15 of the reference in med_tpu; the port never further from
the reference than med_tpu is at its largest, and in the first fold
(no flip on the port's side) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _jax_tecno_like, _port_cfg
from test_torch_families_train import FIELDS, _trial

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.train import loop as jloop
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu_torch.train import loop as tloop
from med_tpu_torch.train.engine import Experiment
from med_tpu_torch.train.optim import make_optimizer
from med_tpu_torch.utils.jax_params import export_jax_params

JAX_NOISE = 0.15


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads, whatever the suite's rule gives: the first
    fold's 1e-5 was measured at two. The thread count sets the float32
    fold's summation order, and with it how far the first epoch's train
    loss lands from the float64 fold: 7.1e-6 at two threads, 1.8e-5 at
    one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _folds(rng):
    names = [f"Needle_Passing_{c}00{i}" for i, c in enumerate("BCDE", 1)]
    trials = [_trial(rng, T, n, learnable=True) for T, n in zip((60, 50, 70, 40), names)]
    return {"1Out": (trials[:3], trials[3:]), "2Out": (trials[1:], trials[:1])}


def _float64_fold(cfg, train, test, frozen):
    """The port's fold with the whole net in float64 (the frozen TeCNo in
    float32, its logits cast up), from the seed's weights."""
    exp = Experiment(cfg, device="cpu")
    exp.init_weights(cfg.seed)
    exp.load_frozen(frozen)
    exp.net.double()
    exp.optimizer = make_optimizer(cfg, exp.net.parameters())
    tecno = exp.frozen

    class CastUp(torch.nn.Module):
        def forward(self, x):
            return tecno(x.float()).double()

    exp.frozen = CastUp()
    exp.load_frozen = lambda _: None
    as_float32 = exp._tensors
    exp._tensors = lambda b: {k: v.double() if v.dtype == torch.float32 else v
                              for k, v in as_float32(b).items()}
    return tloop.train_frame_fold(cfg, train, test, exp=exp, frozen=frozen)


def test_transsvnet_fold_histories_match_jax():
    fields = {**FIELDS, "model_name": "TransSVNet", "n_epochs": 3, "lr": 3e-3}
    jcfg = JaxConfig(**fields)
    cfg = _port_cfg(jcfg)
    frozen = {"tecno_params": _jax_tecno_like(JaxConfig(**{**fields, "model_name": "TeCNo"}))}
    rng = np.random.default_rng(9)
    gaps = {"port": [], "jax": []}
    for fold, (train, test) in _folds(rng).items():
        exp = Experiment(cfg, device="cpu")
        exp.init_weights(cfg.seed)
        tree = export_jax_params(exp.net)
        res = tloop.train_frame_fold(cfg, train, test, exp=exp, frozen=frozen)
        ref = _float64_fold(cfg, train, test, frozen)

        jexp = JaxExperiment(jcfg)
        plain_init = jexp.init_state

        def init_state(rng_key, sample, frozen=None, class_counts=None):
            state = plain_init(rng_key, sample, frozen=frozen)
            params = jax.tree.map(jnp.asarray, tree["params"])
            return state.replace(params=params, opt_state=jexp.tx.init(params))

        jexp.init_state = init_state
        jres = jloop.train_frame_fold(jcfg, train, test, exp=jexp, frozen=frozen)
        assert len(res["history"]) == len(jres["history"]) == len(ref["history"]) == 3
        for row, jrow, want in zip(res["history"], jres["history"], ref["history"]):
            for k in ("train_loss", "test_loss"):
                assert np.isfinite(row[k])
                port, jax_ = (abs(r[k] - want[k]) / abs(want[k]) for r in (row, jrow))
                assert jax_ <= JAX_NOISE, (fold, k, jax_)
                if fold == "1Out":
                    assert port <= 1e-5, (fold, k, port)
                gaps["port"].append(port)
                gaps["jax"].append(jax_)
        assert res["best"]["epoch"] == jres["best"]["epoch"] == ref["best"]["epoch"], fold
    assert max(gaps["port"]) <= max(gaps["jax"]), gaps
    print(f"largest relative loss gap to the float64 fold: port {max(gaps['port']):.3g}, "
          f"med_tpu {max(gaps['jax']):.3g}")
