"""The port's frame serving path (med_tpu_torch.eval.serving) against the
JAX package's FrameModelServer, from one checkpoint file written by the JAX
package; plus the port's checkpoint I/O, batching and device rules.

Same trial, T=120 (not a bucket multiple): equal predictions, probabilities
within 1e-5 (float32, summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.config import ExperimentConfig as JaxConfig
from med_tpu.data import datasets as jdata
from med_tpu.data import labels as jlabels
from med_tpu.eval.serving import FrameModelServer as JaxServer
from med_tpu.train import checkpoint as jckpt
from med_tpu.train.engine import Experiment as JaxExperiment
from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.data import datasets as tdata
from med_tpu_torch.data.labels import skill_one_hot
from med_tpu_torch.eval.serving import FrameModelServer
from med_tpu_torch.train import checkpoint as tckpt

SMALL_COG = dict(model_name="COG", dataset_type="frame", data_type="multimodal",
                 out_features=2, num_layers_Basic=3, num_layers_R=2, num_R=2,
                 mstcn_f_maps=16, d_model=16, d_q=2, sequence_length=5)


def _port_cfg(jcfg: JaxConfig) -> ExperimentConfig:
    names = [f.name for f in dataclasses.fields(ExperimentConfig)]
    return ExperimentConfig(**{n: getattr(jcfg, n) for n in names})


def _jax_checkpoint(tmp_path, jcfg):
    exp = JaxExperiment(jcfg)
    batch = {"images": jnp.zeros((1, 256, 2048)), "kinematics": jnp.zeros((1, 256, 26)),
             "labels": jnp.zeros(256, jnp.int32), "mask": jnp.ones(256, jnp.float32),
             "true_len": jnp.asarray(256, jnp.int32)}
    state = jax.device_get(exp.init_state(jax.random.key(1), batch))
    path = str(tmp_path / "best_model_COG_1Out.npz")
    jckpt.save_checkpoint(path, state.params, state.batch_stats, state.constants)
    return path


@pytest.mark.parametrize("video_dims", [2048, 32])
def test_frame_server_matches_jax(tmp_path, rng, video_dims):
    jcfg = JaxConfig(video_dims=video_dims, **SMALL_COG)
    path = _jax_checkpoint(tmp_path, jcfg)
    stats = {"kinematics": {"mean": rng.normal(size=26).astype(np.float32),
                            "std": rng.uniform(0.5, 2.0, 26).astype(np.float32)}}
    T = 120
    images = rng.normal(size=(T, 2048)).astype(np.float32)
    kin = rng.normal(size=(T, 26)).astype(np.float32)
    want_p, want_pr = JaxServer(jcfg, jckpt.load_checkpoint(path), stats=stats
                                ).predict_trial(images, kin)
    server = FrameModelServer(_port_cfg(jcfg),
                              tckpt.load_best_checkpoint(str(tmp_path), "COG", "1Out"),
                              stats=stats, device="cpu")
    got_p, got_pr = server.predict_trial(images, kin)
    assert got_p.shape == got_pr.shape == (T,)
    np.testing.assert_array_equal(got_p, np.asarray(want_p))
    np.testing.assert_allclose(got_pr, np.asarray(want_pr), rtol=0, atol=1e-5)


def test_frame_server_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    jcfg = JaxConfig(video_dims=2048, **SMALL_COG)
    ckpt = tckpt.load_checkpoint(_jax_checkpoint(tmp_path, jcfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameModelServer(_port_cfg(jcfg), ckpt)


def test_checkpoint_files_cross_between_packages(tmp_path, rng):
    tree = {"model": {"a": {"kernel": rng.normal(size=(3, 2)).astype(np.float32)},
                      "b": rng.normal(size=4).astype(np.float32)}}
    consts = {"model": {"gest_embed": rng.normal(size=(15, 8)).astype(np.float32)}}
    tckpt.save_checkpoint(str(tmp_path / "port"), tree, constants=consts, meta={"x": 1})
    jckpt.save_checkpoint(str(tmp_path / "jax"), tree, constants=consts)
    for got in (jckpt.load_checkpoint(str(tmp_path / "port")),
                tckpt.load_checkpoint(str(tmp_path / "jax"))):
        assert set(got) == {"params", "constants"}
        np.testing.assert_array_equal(got["params"]["model"]["a"]["kernel"],
                                      tree["model"]["a"]["kernel"])
        np.testing.assert_array_equal(got["constants"]["model"]["gest_embed"],
                                      consts["model"]["gest_embed"])
    assert (tmp_path / "port.json").exists()


@pytest.mark.parametrize("T", [1, 120, 256, 257, 5000])
def test_frame_batch_matches_jax(rng, T):
    fields = dict(name="Needle_Passing_C002",
                  images=rng.normal(size=(T, 4)).astype(np.float32),
                  kinematics=rng.normal(size=(T, 26)).astype(np.float32),
                  g_labels=rng.integers(0, 15, T),
                  e_powerset=rng.integers(0, 2, size=(T, 7)).astype(np.int32),
                  skill=skill_one_hot("Needle_Passing_C002", T))
    jcfg = JaxConfig(**SMALL_COG)
    want = jdata.frame_batch(jdata.FrameTrial(**fields), jcfg)
    got = tdata.frame_batch(tdata.FrameTrial(**fields), _port_cfg(jcfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert tdata.bucket_length(T) == jdata.bucket_length(T)
    np.testing.assert_array_equal(skill_one_hot("Needle_Passing_C002", T),
                                  jlabels.skill_one_hot("Needle_Passing_C002", T))
