"""Each plain reference against the port at a tiny size on the CPU (the
port runs its kernels' plain versions there): COG's loss and gradients,
the fine-tune classifier's step with its augmentation and BatchNorm, the
served trunk and probabilities; and whole tiny runs read correct."""

import numpy as np
import pytest
import torch

from conftest import SEED, tiny, tiny_run
from core import spec as specs
from core import weights as W


@pytest.mark.parametrize("cell", ["cog.train", "resnet50.finetune", "cog.pixels"])
def test_a_tiny_run_is_correct(cell):
    run = tiny_run(cell)
    result = run.execute(1.0)
    assert result["correct"], result["checks"]
    for name, c in result["checks"].items():
        assert c["value"] < c["limit"] / 3, (name, c)


def test_sampled_requests_a_short_window_misses_are_served_after_it():
    run = tiny_run("cog.pixels")
    result = run.execute(0.0)
    assert result["attempted"] == 1 and result["correct"], result["checks"]
    assert set(run.driver.outputs) == run.driver.sample


def test_cog_gradients_match_the_port():
    from med_tpu_torch.config import ExperimentConfig
    from med_tpu_torch.train.engine import Experiment

    _, _, cfg, _ = tiny("cog.train")
    ref = specs.load_module("reference", "cog")
    dev = torch.device("cpu")
    weights = W.make(ref.param_spec(cfg), W.generator(SEED, dev), dev)
    table = ref.prompt_table(cfg, W.generator(SEED, dev, 1), dev)
    exp = Experiment(ExperimentConfig(**cfg["experiment"]), device="cpu")
    exp.net.load_state_dict(weights, strict=True)
    exp.net.model.gest_embed.copy_(table)
    T, Tp, C = 70, 256, cfg["experiment"]["mstcn_f_maps"]
    r = np.random.default_rng(0)
    x = np.zeros((Tp, 2074), np.float32)
    x[:T] = r.standard_normal((T, 2074))
    labels = np.zeros(Tp, np.int64)
    labels[:T] = r.integers(0, 2, T)
    g = torch.Generator().manual_seed(1)
    slow, fast = ref.stage_names(cfg["experiment"]["num_R"])
    masks = {}
    for i, n in enumerate(slow + fast):
        L = 3 if n in (slow[0], fast[0]) else 2
        t = Tp if n in slow else Tp // 16
        masks[n] = {"stack": torch.randint(0, 2, (L, 1, t, C), generator=g, dtype=torch.uint8)}
    for n in (slow[0], fast[0]):
        masks[n]["channel"] = torch.randint(0, 2, (1, 1, C), generator=g).float()
    batch = {"images": x[None, :, :2048], "kinematics": x[None, :, 2048:], "labels": labels,
             "mask": (np.arange(Tp) < T).astype(np.float32), "true_len": np.int32(T)}
    loss, _ = exp.compute_gradients(batch, masks=masks)
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = ref.loss(ref.forward(p, cfg, table, torch.from_numpy(x), masks),
                    torch.from_numpy(labels), T, cfg["experiment"]["smooth_lambda"])
    want.backward()
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    for name, param in exp.net.named_parameters():
        ref_grad = p[name].grad if p[name].grad is not None else torch.zeros_like(param)
        scale = float(ref_grad.abs().max()) + 1e-12
        assert float((param.grad - ref_grad).abs().max()) <= 1e-4 * scale, name


def test_finetune_step_matches_the_port():
    from med_tpu_torch.data.augment import augment_batch, draw_augment
    from med_tpu_torch.models.resnet import ResNetClassifier

    _, _, cfg, _ = tiny("resnet50.finetune")
    rn = specs.load_module("reference", "resnet50")
    aug = specs.load_module("reference", "augment")
    dev = torch.device("cpu")
    spec = rn.param_spec(cfg["stage_sizes"], cfg["width"], 0.2, 0.1, prefix="trunk.",
                         head=(cfg["head_hidden"], cfg["classes"]))
    weights = W.make(spec, W.generator(SEED, dev), dev)
    frames = torch.randint(0, 256, (8, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    frames = frames.float()
    mean, std = torch.tensor([0.5, 0.4, 0.45]), torch.tensor([0.29, 0.3, 0.28])
    draws = draw_augment(8, torch.Generator().manual_seed(3))
    got_x = augment_batch(frames, draws, normalize=(mean, std))
    want_x = aug.augment(frames, draws, mean, std)
    assert float((got_x - want_x).abs().max()) < 1e-4
    model = ResNetClassifier(cfg["stage_sizes"], cfg["width"], cfg["classes"])
    model.load_state_dict(weights, strict=True)
    got = model(got_x, train=True)
    state = {}
    want = rn.classifier(weights, want_x, cfg["stage_sizes"], train=True, state=state)
    assert float((got - want).abs().max()) < 1e-4 * (1 + float(want.abs().max()))
    for name, buf in model.named_buffers():
        assert torch.allclose(buf, state[name], rtol=1e-4, atol=1e-5), name


def test_served_trunk_matches_the_port_in_float32():
    from med_tpu_torch.models.resnet import ResNet50

    _, _, cfg, _ = tiny("cog.pixels")
    fe = cfg["front_end"]
    rn = specs.load_module("reference", "resnet50")
    dev = torch.device("cpu")
    weights = W.make(rn.param_spec(fe["stage_sizes"], fe["width"]), W.generator(SEED, dev), dev)
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    rn.trunk(weights, x, fe["stage_sizes"], calibrate=True)
    net = ResNet50(fe["stage_sizes"], fe["width"])
    net.load_state_dict(weights, strict=True)
    got, want = net(x), rn.trunk(weights, x, fe["stage_sizes"])
    assert float((got - want).norm() / want.norm()) < 1e-5
