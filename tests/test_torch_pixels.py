"""The port's pixel serving path (med_tpu_torch.eval.serving:
PixelFrontEnd, FrameModelServer.predict_trial_from_pixels) against the JAX
package's, on the same numpy frames and the same checkpoints.

Tolerances: float32 features rtol/atol 1e-5 (summed in another order);
bfloat16 features through JAX's jit within a relative L2 of 2e-2, since XLA
fuses a conv's epilogue into the next ops and drops some of the bf16
roundings that the eager graph (and the port) make; served predictions
equal and probabilities within 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.eval.serving import FrameModelServer as JaxServer
from med_tpu.eval.serving import PixelFrontEnd as JaxFrontEnd
from med_tpu.models.resnet import ResNet50 as JaxResNet50
from med_tpu.train import checkpoint as jckpt
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.eval.serving import FrameModelServer, PixelFrontEnd
from med_tpu_torch.parallel.mesh import make_mesh

BF16_JIT_REL = 2e-2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _trunk(seed: int, stage_sizes, width: int, hw: int):
    """Flax trunk variables with BN running statistics perturbed (as
    tests/test_serving.py does) so that folding is exercised."""
    rng = np.random.default_rng(seed)
    v = jax.jit(lambda: JaxResNet50(stage_sizes, width, jnp.float32).init(
        jax.random.key(seed), jnp.zeros((1, hw, hw, 3))))()
    stats = jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(rng.normal(size=a.shape), jnp.float32) ** 2,
        v["batch_stats"])
    return jax.device_get(v["params"]), jax.device_get(stats)


@pytest.fixture(scope="module")
def tiny():
    return _trunk(0, (1, 1, 1, 1), 8, 40)


@pytest.fixture(scope="module")
def small():
    return _trunk(1, (2, 2, 1, 1), 8, 64)


def _front_ends(params, stats, stage_sizes, width, batch_size, **kw):
    jfe = JaxFrontEnd(params, stats, dtype=jnp.float32, stage_sizes=stage_sizes,
                      width=width, batch_size=batch_size, **kw)
    tkw = dict(dtype=torch.float32, stage_sizes=stage_sizes, width=width,
               batch_size=batch_size, device="cpu", **kw)
    return jfe, tkw


@pytest.mark.parametrize("batch_size", [8, 13])
def test_pixel_front_end_fold_stats_matches_jax(small, rng, batch_size):
    """Fold-stats preprocessing on 13 frames, in chunks of 8 (the last one
    zero-padded) or in one chunk of 13 (no padding)."""
    params, stats = small
    frames = rng.integers(0, 256, size=(13, 64, 64, 3)).astype(np.uint8)
    mean = rng.uniform(0.3, 0.7, 3).astype(np.float32)
    std = rng.uniform(0.1, 0.3, 3).astype(np.float32)
    jfe, tkw = _front_ends(params, stats, (2, 2, 1, 1), 8, batch_size, mean=mean, std=std)
    want = jfe.features(frames)
    got = PixelFrontEnd(params, stats, **tkw).features(frames)
    assert got.shape == (13, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pixel_front_end_bf16_matches_jax(tiny, rng):
    params, stats = tiny
    frames = rng.integers(0, 256, size=(5, 40, 40, 3)).astype(np.uint8)
    kw = dict(mean=np.full(3, 0.5, np.float32), std=np.full(3, 0.25, np.float32),
              stage_sizes=(1, 1, 1, 1), width=8, batch_size=4)
    want = JaxFrontEnd(params, stats, dtype=jnp.bfloat16, **kw).features(frames)
    got = PixelFrontEnd(params, stats, dtype=torch.bfloat16, device="cpu", **kw).features(frames)
    assert _rel(got, want) <= BF16_JIT_REL


@pytest.mark.parametrize("hw", [(240, 240), (480, 640)])
def test_pixel_front_end_imagenet_path_matches_jax(tiny, rng, hw):
    params, stats = tiny
    frames = rng.integers(0, 256, size=(3, *hw, 3)).astype(np.uint8)
    jfe, tkw = _front_ends(params, stats, (1, 1, 1, 1), 8, 2)
    got = PixelFrontEnd(params, stats, **tkw).features(frames)
    np.testing.assert_allclose(got, jfe.features(frames), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extension", [True, False])
def test_pixel_front_end_from_a_jax_checkpoint(tmp_path, tiny, rng, extension):
    """A fine-tune checkpoint as med_tpu writes it (trunk under
    params/trunk and batch_stats/trunk beside the head, meta in JSON)."""
    params, stats = tiny
    mean = rng.uniform(0.3, 0.7, 3).astype(np.float32)
    std = rng.uniform(0.1, 0.3, 3).astype(np.float32)
    head = {"fc1": {"kernel": np.zeros((256, 512), np.float32)}}
    path = str(tmp_path / ("resnet50_1Out.npz" if extension else "resnet50_1Out"))
    jckpt.save_checkpoint(path, {"trunk": params, **head}, {"trunk": stats},
                          meta={"mean": mean.tolist(), "std": std.tolist(), "best_acc": 0.5})
    if not extension:   # np.savez added the extension; the meta stayed at <path>.json
        assert json.load(open(path + ".json"))["best_acc"] == 0.5
    frames = rng.integers(0, 256, size=(6, 40, 40, 3)).astype(np.uint8)
    kw = dict(dtype=jnp.float32, stage_sizes=(1, 1, 1, 1), width=8, batch_size=4)
    want = JaxFrontEnd.from_checkpoint(path, **kw).features(frames)
    kw["dtype"] = torch.float32
    fe = PixelFrontEnd.from_checkpoint(path, device="cpu", **kw)
    np.testing.assert_allclose(fe.mean.numpy(), mean)
    np.testing.assert_allclose(fe.features(frames), want, rtol=1e-5, atol=1e-5)


def test_frame_server_from_pixels_matches_jax(tmp_path, rng):
    """Raw frames -> a small trunk at width 64 (2048-d features) -> a small
    COG, in both packages from the same checkpoints: equal predictions,
    probabilities within 1e-5; and the port's pixel request equals its
    predict_trial on the same front end's features."""
    cog = dict(model_name="COG", dataset_type="frame", data_type="multimodal",
               out_features=2, num_layers_Basic=3, num_layers_R=2, num_R=2,
               mstcn_f_maps=16, d_model=16, d_q=2, sequence_length=5, video_dims=32)
    jcfg = JaxConfig(**cog)
    batch = {"images": jnp.zeros((1, 256, 2048)), "kinematics": jnp.zeros((1, 256, 26)),
             "labels": jnp.zeros(256, jnp.int32), "mask": jnp.ones(256, jnp.float32),
             "true_len": jnp.asarray(256, jnp.int32)}
    exp = JaxExperiment(jcfg)
    state = jax.device_get(jax.jit(lambda k: exp.init_state(k, batch))(jax.random.key(2)))
    ckpt = {"params": state.params, "constants": state.constants}
    params, tstats = _trunk(2, (1, 1, 1, 1), 64, 32)
    mean, std = np.full(3, 0.45, np.float32), np.full(3, 0.22, np.float32)
    stats = {"kinematics": {"mean": rng.normal(size=26).astype(np.float32),
                            "std": rng.uniform(0.5, 2.0, 26).astype(np.float32)}}
    T = 50
    frames = rng.integers(0, 256, size=(T, 32, 32, 3)).astype(np.uint8)
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    kw = dict(mean=mean, std=std, stage_sizes=(1, 1, 1, 1), width=64, batch_size=16)

    jfe = JaxFrontEnd(params, tstats, dtype=jnp.float32, **kw)
    want_p, want_pr = JaxServer(jcfg, ckpt, stats=stats).predict_trial_from_pixels(
        jfe, frames, kin)
    tfe = PixelFrontEnd(params, tstats, dtype=torch.float32, device="cpu", **kw)
    server = FrameModelServer(ExperimentConfig(**cog), ckpt, stats=stats, device="cpu")
    got_p, got_pr = server.predict_trial_from_pixels(tfe, frames, kin)
    assert got_p.shape == got_pr.shape == (T,)
    np.testing.assert_array_equal(got_p, np.asarray(want_p))
    np.testing.assert_allclose(got_pr, np.asarray(want_pr), rtol=0, atol=1e-5)
    again_p, again_pr = server.predict_trial(tfe.features(frames), kin)
    np.testing.assert_array_equal(got_p, again_p)
    np.testing.assert_allclose(got_pr, again_pr, rtol=1e-6)


def test_pixel_front_end_unported_options_and_device_rule(tiny, rng):
    """The int8 trunk (ported since) needs its calibration frames and then
    serves finite features of the trunk's width; on a mesh of one rank (a
    mesh was once refused, naming A12) the features are the same; the
    default device is CUDA, which must be there."""
    params, stats = tiny
    kw = dict(stage_sizes=(1, 1, 1, 1), width=8, device="cpu")
    with pytest.raises(ValueError, match="calib_frames"):
        PixelFrontEnd(params, stats, int8=True, **kw)
    frames = rng.integers(0, 256, size=(3, 40, 40, 3)).astype(np.uint8)
    fe = PixelFrontEnd(params, stats, int8=True, calib_frames=frames, mean=[0.5] * 3,
                       std=[0.25] * 3, batch_size=2, **kw)
    got = fe.features(frames)
    assert got.shape == (3, 256) and got.dtype == np.float32 and np.isfinite(got).all()
    meshed = PixelFrontEnd(params, stats, int8=True, calib_frames=frames, mean=[0.5] * 3,
                           std=[0.25] * 3, batch_size=2, mesh=make_mesh(), **kw)
    np.testing.assert_array_equal(meshed.features(frames), got)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PixelFrontEnd(params, stats, stage_sizes=(1, 1, 1, 1), width=8)
