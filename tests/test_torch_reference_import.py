"""The port's importer of reference ``.pt`` checkpoints
(med_tpu_torch.utils.torch_port) against the JAX package's: a synthetic
reference COG state dict, built with the reference's own key names, goes
through both importers and gives the same tree, and the same logits from
both packages' models (and from the torch oracle that made the state dict).
Tolerance on logits: rtol 1e-4, atol 1e-4, as the JAX package's own
full-COG parity test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

# the torch oracle with the reference's state_dict key names
from test_cog_full_parity import (D_MODEL, D_Q, F_DIM, F_MAPS, GEST_DIM, LEN_Q, N_CLS,
                                  NLB, NLR, NUM_R, POOL, RefCOG, T)
from test_torch_port import ref_style_feature_extractor

from med_tpu.models.cog import COG as JaxCOG
from med_tpu.train import checkpoint as jckpt
from med_tpu.utils import torch_port as jport
from med_tpu_torch.models.cog import COG
from med_tpu_torch.models.feature_extractor import FeatureExtractor
from med_tpu_torch.train import checkpoint as tckpt
from med_tpu_torch.train.engine import FrameNet
from med_tpu_torch.utils import torch_port as tport
from med_tpu_torch.utils.jax_params import load_jax_params


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture
def reference_blob(tmp_path, rng):
    torch.manual_seed(0)
    oracle = RefCOG().eval()
    with torch.no_grad():
        for mod in oracle.modules():
            if isinstance(mod, tnn.LayerNorm):
                mod.weight.copy_(torch.tensor(rng.normal(1.0, 0.2, mod.weight.shape),
                                              dtype=torch.float32))
                mod.bias.copy_(torch.tensor(rng.normal(0.0, 0.3, mod.bias.shape),
                                            dtype=torch.float32))
    fe = ref_style_feature_extractor(video_dims=F_DIM)
    with torch.no_grad():
        # features of unit scale, as the oracle's own parity test feeds it: at
        # torch's default init they come out at std 0.085, where this oracle
        # and BOTH packages part by 2e-3 (the two packages still agree)
        fe.linear.output.weight.mul_(10.0)
        fe.linear.output.bias.mul_(10.0)
    ckpt_dir = tmp_path / "checkpoints"
    ckpt_dir.mkdir()
    path = str(ckpt_dir / "best_model_LOSO_1Out.pt")
    torch.save({"feature_extractor": fe.state_dict(), "model": oracle.state_dict()}, path)
    return oracle, fe, path


def test_both_importers_give_the_same_tree(reference_blob):
    _, _, path = reference_blob
    want = _leaves(jport.import_reference_checkpoint(path, "COG"))
    got = _leaves(tport.import_reference_checkpoint(path, "COG"))
    assert set(got) == set(want) and len(want) > 60
    assert any(p.startswith("params/fe/") for p in want)
    assert "constants/model/gest_embed" in want
    for p, w in want.items():
        np.testing.assert_array_equal(got[p], w, err_msg=p)


def test_load_best_checkpoint_falls_back_to_the_reference_blob(reference_blob):
    _, _, path = reference_blob
    ckpt_dir = path.rsplit("/", 1)[0]
    got = _leaves(tckpt.load_best_checkpoint(ckpt_dir, "LOSO", "1Out", model_name="COG"))
    want = _leaves(jckpt.load_best_checkpoint(ckpt_dir, "LOSO", "1Out", model_name="COG"))
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_array_equal(got[p], w, err_msg=p)
    with pytest.raises(ValueError, match="model_name"):
        tckpt.load_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        tckpt.load_best_checkpoint(ckpt_dir, "LOSO", "2Out", model_name="COG")


def test_imported_reference_cog_gives_the_same_logits_in_both_packages(reference_blob, rng):
    oracle, fe, path = reference_blob
    raw = rng.normal(size=(1, T, 2048)).astype(np.float32)
    with torch.no_grad():
        feats = fe.linear(torch.tensor(raw))
        want = [t.numpy().transpose(0, 2, 1) for t in oracle(feats)]

    jtree = jport.import_reference_checkpoint(path, "COG")
    jmodel = JaxCOG(num_layers_basic=NLB, num_layers_r=NLR, num_r=NUM_R, f_maps=F_MAPS,
                    f_dim=F_DIM, out_classes=N_CLS, d_model=D_MODEL, d_q=D_Q, len_q=LEN_Q,
                    gest_dim=GEST_DIM, fast_pool=POOL, use_pallas=False)
    jax_out, _ = jmodel.apply({"params": jtree["params"]["model"],
                               "constants": jtree["constants"]["model"]},
                              jnp.asarray(feats.numpy()), train=False)

    net = FrameNet(COG(num_layers_basic=NLB, num_layers_r=NLR, num_r=NUM_R, f_maps=F_MAPS,
                       f_dim=F_DIM, out_classes=N_CLS, d_model=D_MODEL, d_q=D_Q,
                       len_q=LEN_Q, gest_dim=GEST_DIM, fast_pool=POOL),
                   FeatureExtractor(output_dim=F_DIM)).eval()
    state, constants = load_jax_params(tport.import_reference_checkpoint(path, "COG"), net)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        for name, value in constants.items():
            net.get_buffer(name).copy_(value)
        port_feats = net.fe(torch.tensor(raw))
        port_out, _ = net.model(port_feats)
    np.testing.assert_allclose(port_feats.numpy(), feats.numpy(), rtol=1e-5, atol=1e-5)
    assert len(port_out) == len(want) == 4 + 1 + NUM_R
    for k, (got, j, w) in enumerate(zip(port_out, jax_out, want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4,
                                   err_msg=f"track {k} vs med_tpu")
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"track {k} vs the torch oracle")


@pytest.mark.parametrize("family, roadmap", [("TeCNo", "A6"), ("TransSVNet", "A6"),
                                             ("SimpleCNN", "A7"), ("Siamese_LSTM", "A7")])
def test_other_families_importers_name_their_roadmap_item(reference_blob, family, roadmap):
    with pytest.raises(NotImplementedError, match=roadmap):
        tport.import_reference_checkpoint(reference_blob[2], family)
    with pytest.raises(ValueError, match="unknown"):
        tport.import_reference_checkpoint(reference_blob[2], "ResNet")
