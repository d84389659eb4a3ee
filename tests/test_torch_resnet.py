"""The port's ResNet-50 trunk pieces (med_tpu_torch: data.preprocessing,
models.resnet, utils.jax_params' conv2d and batchnorm layouts,
ops.resnet_fused) against the JAX package's, on the same numpy inputs and
weights.

The JAX fused stage runs its Pallas kernel in interpret mode, as
tests/test_resnet_fused.py does; the port's runs its plain version (CPU
tensors). Tolerances: float32 results within 1e-5 (relative L2 for whole
tensors, rtol/atol 1e-5 elementwise), float32 summed in another order.
bfloat16, op by op (flax apply, the Pallas kernel in interpret mode): a
relative L2 of 2**-8, one bf16 rounding (both packages round at the same
points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.data.preprocessing import _resize_crop_matrix as jax_resize_crop_matrix
from med_tpu.data.preprocessing import jax_preprocess_frames
from med_tpu.models.resnet import ResNet50 as JaxResNet50
from med_tpu.models.resnet import import_torchvision_resnet50 as jax_import_torchvision
from med_tpu.ops import resnet_fused as jrf
from med_tpu_torch.data.preprocessing import _resize_crop_matrix, preprocess_frames
from med_tpu_torch.models.resnet import (
    ResNet50,
    import_torchvision_resnet50,
    load_pretrained_trunk,
)
from med_tpu_torch.ops import resnet_fused as trf
from med_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

BF16_REL = 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


@pytest.mark.parametrize("n_in", [480, 640, 300, 120, 240])
def test_resize_crop_matrix_matches_jax(n_in):
    got = _resize_crop_matrix(n_in, 240, 8, 232)
    want = jax_resize_crop_matrix(n_in, 240, 8, 232)
    assert got.shape == want.shape == (n_in, 224)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got.flags.writeable


@pytest.mark.parametrize("hw", [(480, 640), (240, 240)])
def test_preprocess_frames_matches_jax(rng, hw):
    frames = rng.integers(0, 256, size=(2, *hw, 3)).astype(np.uint8)
    got = preprocess_frames(torch.from_numpy(frames))
    want = np.asarray(jax_preprocess_frames(frames))
    assert got.shape == (2, 224, 224, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_resnet50_matches_flax(tiny, rng, dtype):
    jdt, tdt = DTYPES[dtype]
    params, stats = tiny
    x = rng.normal(size=(3, 40, 40, 3)).astype(np.float32)
    want = np.asarray(JaxResNet50((1, 1, 1, 1), 8, jdt).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    net = ResNet50((1, 1, 1, 1), 8, tdt)
    state, constants = load_jax_params({"params": params, "batch_stats": stats}, net)
    assert constants == {}
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (3, 256) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got, want) <= BF16_REL


def _random_tree(shapes, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def test_resnet50_weights_round_trip_at_full_width():
    """Every leaf of a full-width flax trunk maps onto the port's state_dict
    and back unchanged (shapes from jax.eval_shape: nothing is computed)."""
    shapes = jax.eval_shape(lambda: JaxResNet50().init(jax.random.key(0),
                                                      jnp.zeros((1, 224, 224, 3))))
    tree = _random_tree(dict(shapes), 3)
    net = ResNet50()
    state, _ = load_jax_params(tree, net)
    net.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in net.parameters()) == 23_508_032
    back = dict(_leaves(export_jax_params(net)))
    want = dict(_leaves(tree))
    assert set(back) == set(want) and len(want) == 53 + 4 * 53
    for path, value in want.items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def _torchvision_state_dict(seed: int):
    """A torchvision resnet50 state_dict's keys and shapes, seeded values."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rng.normal(size=(o, i, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.normal(size=c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(size=c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(size=c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for b in range(n_blocks):
            src = f"layer{stage + 1}.{b}"
            conv(f"{src}.conv1", f, cin, 1)
            bn(f"{src}.bn1", f)
            conv(f"{src}.conv2", f, f, 3)
            bn(f"{src}.bn2", f)
            conv(f"{src}.conv3", 4 * f, f, 1)
            bn(f"{src}.bn3", 4 * f)
            if b == 0:
                conv(f"{src}.downsample.0", 4 * f, cin, 1)
                bn(f"{src}.downsample.1", 4 * f)
            cin = 4 * f
    sd["fc.weight"] = rng.normal(size=(1000, 2048)).astype(np.float32)
    sd["fc.bias"] = rng.normal(size=1000).astype(np.float32)
    return sd


def test_torchvision_importer_matches_jax(tmp_path):
    sd = _torchvision_state_dict(4)
    jparams, jstats = jax_import_torchvision(sd)
    want = dict(_leaves({"params": jparams, "batch_stats": jstats}))
    np.savez(tmp_path / "resnet50.npz", **sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "resnet50.pth")
    for state in (import_torchvision_resnet50(sd),
                  load_pretrained_trunk(str(tmp_path / "resnet50.npz")),
                  load_pretrained_trunk(str(tmp_path / "resnet50.pth"))):
        net = ResNet50()
        net.load_state_dict(state, strict=True)
        got = dict(_leaves(export_jax_params(net)))
        assert set(got) == set(want)
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg=path)


def _stage_blocks(params, stats, layer, idxs, fold):
    return [fold(params[f"{layer}_{b}"], stats[f"{layer}_{b}"]) for b in idxs]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layer,idxs,hw,cin", [("layer1", (0, 1), 16, 8),
                                               ("layer2", (1,), 8, 64),
                                               ("layer1", (0,), (12, 20), 8),
                                               ("layer2", (1,), (6, 12), 64)])
def test_fused_stage_plain_matches_pallas_interpret(small, rng, dtype, layer, idxs, hw, cin):
    """The plain stage (CPU path of fused_bottleneck_stage) against the
    Pallas kernel in interpret mode: layer1 includes the stride-1
    projection block (Cin 8, 4f 32), layer2 an identity block; square
    images, and images whose H*W is a multiple of 8 but whose row length
    W is not (the CUDA kernel's 128-row tiles and 8-row fragments then cut
    image rows)."""
    jdt, tdt = DTYPES[dtype]
    params, stats = small
    H, W = (hw, hw) if isinstance(hw, int) else hw
    x = rng.normal(size=(2, H * W, cin)).astype(np.float32)
    jblocks = _stage_blocks(params, stats, layer, idxs, jrf.fold_bottleneck_params)
    tblocks = _stage_blocks(params, stats, layer, idxs, trf.fold_bottleneck_params)
    for jb, tb in zip(jblocks, tblocks):
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=1e-6, atol=1e-7)
    want = np.asarray(jrf.fused_bottleneck_stage(jnp.asarray(x), jblocks, Wr=W, dtype=jdt,
                                                 interpret=True)).astype(np.float32)
    before = trf.fused_bottleneck_stage.launches
    got = trf.fused_bottleneck_stage(torch.from_numpy(x), tblocks, Wr=W, dtype=tdt)
    assert trf.fused_bottleneck_stage.launches == before      # the CPU runs no kernel
    assert got.dtype == tdt and got.shape == want.shape
    assert _rel(got.float(), want) <= (1e-5 if dtype == "float32" else BF16_REL)


def test_stage_work_at_full_width():
    """K10's work count from shapes, as chip_smoke.py prints it: stages 0
    and 1 of the full-width trunk at B = 128 in bf16 come to 338.7 GFLOP
    (0.3425 ms on an H100's bf16 tensor cores) and, through the three
    launches a block, 3.39 GB (1.01 ms at 3.35 TB/s)."""
    s0 = trf.stage_work(128, 56 * 56, [(64, 64, True), (256, 64, False), (256, 64, False)])
    s1 = trf.stage_work(128, 28 * 28, [(512, 128, False)] * 3)
    assert (s0["flops"], s1["flops"]) == (170_993_385_472, 167_705_051_136)
    assert round((s0["flops"] + s1["flops"]) / 1e9, 1) == 338.7
    floor = s0["floor_bytes"] + s1["floor_bytes"]
    assert round(floor / 1e9, 2) == 3.39
    # stage 0 block 0 alone: 514 MB of activations through its three launches
    b0 = trf.stage_work(128, 56 * 56, [(64, 64, True)])
    assert round(b0["floor_bytes"] / 1e6) == 514
    for s in (s0, s1):
        assert s["flops"] == sum(v["flops"] for v in s["launches"].values())
        assert s["floor_bytes"] == sum(v["bytes"] for v in s["launches"].values())
        assert s["bytes"] < s["floor_bytes"]
    # the 3x3 launches sit above the bf16 ridge (~295 flop/byte), the others far below
    ridge = {k: (s0["launches"][k]["flops"] + s1["launches"][k]["flops"])
             / (s0["launches"][k]["bytes"] + s1["launches"][k]["bytes"]) for k in s0["launches"]}
    assert ridge["conv3"] > 295 and ridge["reduce"] < 100 and ridge["expand"] < 100


def test_fused_stage_rejects_what_the_tpu_kernel_rejects(small):
    params, stats = small
    blocks = _stage_blocks(params, stats, "layer1", (0,), trf.fold_bottleneck_params)
    with pytest.raises(ValueError, match="8-aligned"):
        trf.fused_bottleneck_stage(torch.zeros(1, 25, 8), blocks, Wr=5)
    with pytest.raises(ValueError, match="row length"):
        trf.fused_bottleneck_stage(torch.zeros(1, 24, 8), blocks, Wr=5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_resnet50_fused_apply_matches_jax(small, rng, dtype):
    jdt, tdt = DTYPES[dtype]
    params, stats = small
    variables = {"params": params, "batch_stats": stats}
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jrf.resnet50_fused_apply(variables, jnp.asarray(x), stage_sizes=(2, 2, 1, 1),
                                               dtype=jdt, fused_stages=(0, 1), interpret=True))
    got = trf.resnet50_fused_apply(variables, torch.from_numpy(x), stage_sizes=(2, 2, 1, 1),
                                   dtype=tdt, fused_stages=(0, 1))
    assert got.shape == (2, 256) and got.dtype == torch.float32
    assert _rel(got, want) <= (1e-5 if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_resnet50_fused_apply_folded_once_is_the_same(small, rng, dtype):
    """The trunk folded once by fold_trunk gives exactly what folding on
    every call gives, on the fused stages and on the conv path."""
    tdt = DTYPES[dtype][1]
    params, stats = small
    variables = {"params": params, "batch_stats": stats}
    folded = trf.fold_trunk(variables, dtype=tdt, device="cpu")
    assert folded["layer1_0"]["down_conv"][0].dtype == tdt
    assert folded["layer1_0"]["down_conv"][1].dtype == torch.float32
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    for fused_stages in ((0, 1), ()):
        kw = dict(stage_sizes=(2, 2, 1, 1), dtype=tdt, fused_stages=fused_stages)
        torch.testing.assert_close(trf.resnet50_fused_apply(folded, x, **kw),
                                   trf.resnet50_fused_apply(variables, x, **kw), rtol=0, atol=0)
    other = torch.float32 if tdt == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="folded trunk"):
        trf.resnet50_fused_apply(folded, x, stage_sizes=(2, 2, 1, 1), dtype=other)
