"""The int8 post-training-quantized serving path (med_tpu_torch.ops.quant,
PixelFrontEnd(int8=True)) against med_tpu.ops.quant on the same numpy
trees and inputs, on the CPU (the kernel's plain version).

Tolerances: numpy primitives (weight quantization, the BN fold) exactly
equal; calibration scales rtol 1e-6 (the same fp32 statistics, summed in
another order by another conv); with med_tpu's quantized tree carried
across, int32 accumulators exactly equal layer by layer and int8 codes
equal except ±1 flips where y / s_out lies within float32 noise of a
rounding tie, counted and held to 1e-4 of the codes; features within 1e-5
of their largest where no code flipped; the port's own quantize -> apply
within tests/test_quant.py's drift bounds of the fp32 trunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.eval.serving import PixelFrontEnd as JaxFrontEnd
from med_tpu.models.feature_extractor import FeatureExtractor as JaxFE
from med_tpu.models.resnet import ResNet50 as JaxResNet50
from med_tpu.ops import quant as jq
from med_tpu.train import checkpoint as jckpt
from med_tpu_torch.eval.serving import PixelFrontEnd
from med_tpu_torch.ops import quant as tq
from med_tpu_torch.utils.jax_params import load_jax_quant_fe, load_jax_quant_trunk

FLIP_FRAC = 1e-4



def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module", params=[(1, 1, 1, 1), (2, 2, 2, 2)], ids=["1111", "2222"])
def trunk(request):
    """A flax trunk at width 8 on 64x64 inputs, its fp32 features and both
    packages' quantized trees calibrated on the same batch."""
    ss = request.param
    model = JaxResNet50(stage_sizes=ss, width=8)
    rng = np.random.default_rng(5 if ss[0] == 2 else 1)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    variables = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.key(2 if ss[0] == 2 else 0)},
        jnp.zeros((1, 64, 64, 3)), train=False))())
    ref = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x))
    jqt = jax.device_get(jq.quantize_resnet50_trunk(variables, x, stage_sizes=ss))
    return dict(ss=ss, x=x, variables=variables, ref=ref, jqt=jqt,
                tqt=tq.quantize_resnet50_trunk(variables, x, ss))


def test_quantize_tensor_rounds_half_to_even_and_clips():
    x = np.asarray([0.24, 0.26, -0.25, 100.0, -100.0, 0.75, 1.25, -0.75], np.float32)
    got = tq.quantize_tensor(_t(x), np.float32(0.5)).numpy()
    np.testing.assert_array_equal(got, [0, 1, 0, 127, -127, 2, 2, -2])
    np.testing.assert_array_equal(got, np.asarray(jq.quantize_tensor(jnp.asarray(x),
                                                                      np.float32(0.5))))
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) * 3
    s = np.float32(0.0371)
    np.testing.assert_array_equal(tq.quantize_tensor(_t(x), s).numpy(),
                                  np.asarray(jq.quantize_tensor(jnp.asarray(x), s)))


def test_weight_quantization_and_bn_fold_equal_jax():
    rng = np.random.default_rng(0)
    conv = {"kernel": rng.normal(size=(3, 3, 8, 6)).astype(np.float32)}
    bn_p = {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
            "bias": rng.normal(size=6).astype(np.float32)}
    bn_s = {"mean": rng.normal(size=6).astype(np.float32),
            "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    for a, b in zip(tq.fold_conv_bn(conv, bn_p, bn_s), jq.fold_conv_bn(conv, bn_p, bn_s)):
        np.testing.assert_array_equal(a, b)
    k = tq.fold_conv_bn(conv, bn_p, bn_s)[0]
    for a, b in zip(tq.quantize_weights_per_channel(k), jq.quantize_weights_per_channel(k)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_leaves(v, path) if isinstance(v, (dict, list)) else {path: v})
    return out


def test_calibration_and_quantized_tree_match_jax(trunk):
    """The port's tree against med_tpu's carried across: int8 weights equal,
    scales and biases at rtol 1e-6."""
    carried = _leaves(load_jax_quant_trunk(trunk["jqt"], trunk["ss"]))
    own = _leaves(trunk["tqt"])
    assert set(carried) == set(own)
    for path, want in carried.items():
        got = own[path]
        if want.dtype == torch.int8:
            assert torch.equal(got, want), path
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, err_msg=path)


def test_quantized_trees_carry_across_whole():
    tree = {"layers": [{"wq": np.zeros((4, 3), np.int8), "wscale": np.ones(3, np.float32),
                        "bias": np.zeros(3, np.float32), "in_scale": np.float32(0.1)}]}
    assert load_jax_quant_fe(tree)["layers"][0]["wq"].shape == (3, 4)
    with pytest.raises(KeyError, match="extra"):
        load_jax_quant_fe({"layers": [dict(tree["layers"][0], extra=np.zeros(1))]})
    with pytest.raises(KeyError, match="in_scale"):
        load_jax_quant_fe({"layers": [{k: v for k, v in tree["layers"][0].items()
                                       if k != "in_scale"}]})


def _lockstep(qt_j, qt_t, x, ss):
    """Both packages' int8 trunks side by side on the port's codes: each
    conv's int32 accumulators compared exactly, each fp32 output equal,
    each requantized tensor's codes counted for flips; returns (flips,
    codes)."""
    flips = codes = 0

    def conv(xq, jc, tc, s_in, stride, pad, **kw):
        nonlocal flips, codes
        acc_j = np.asarray(jq._conv_i8(jnp.asarray(xq.numpy()), jnp.asarray(jc["wq"]),
                                       stride, pad))
        acc_t = tq.int8_conv(xq, tc["wq"], tc["wscale"], tc["bias"], s_in=s_in,
                             stride=stride, pad=pad, accumulators=True).numpy()
        np.testing.assert_array_equal(acc_t, acc_j)
        got = tq.int8_conv(xq, tc["wq"], tc["wscale"], tc["bias"], s_in=s_in, stride=stride,
                           pad=pad, **kw)
        y = jq._dequant_epilogue(jnp.asarray(acc_j), s_in, jc)
        res = kw.get("residual")
        if res is not None:
            y = y + (jnp.asarray(res.numpy()).astype(jnp.float32) * kw["res_scale"]
                     if res.dtype == torch.int8 else jnp.asarray(res.numpy()))
        if kw.get("relu"):
            y = jax.nn.relu(y)
        if kw.get("out_scale") is None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(y))
            return got
        want = np.asarray(jq.quantize_tensor(y, kw["out_scale"])).astype(np.int32)
        diff = np.abs(got.numpy().astype(np.int32) - want)
        assert diff.max() <= 1
        flips += int((diff > 0).sum())
        codes += diff.size
        return got

    s = qt_j["in_scale"]
    xq = tq.quantize_tensor(_t(x), s)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq.quantize_tensor(x, s)))
    y = conv(xq, qt_j["conv1"], qt_t["conv1"], s, 2, 3, relu=True,
             out_scale=qt_j["conv1"]["out_scale"])
    pooled = tq._max_pool_i8(y)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(jq._max_pool(jnp.asarray(y.numpy()))))
    y = pooled
    s = qt_j["conv1"]["out_scale"]
    for name, stride, has_down in tq.block_geometry(ss):
        j, t = qt_j[name], qt_t[name]
        a = conv(y, j["c1"], t["c1"], s, 1, 0, relu=True, out_scale=j["a1"])
        a = conv(a, j["c2"], t["c2"], j["a1"], stride, 1, relu=True, out_scale=j["a2"])
        if has_down:
            res = conv(y, j["down"], t["down"], s, stride, 0)
            y = conv(a, j["c3"], t["c3"], j["a2"], 1, 0, residual=res, relu=True,
                     out_scale=j["out"])
        else:
            y = conv(a, j["c3"], t["c3"], j["a2"], 1, 0, residual=y, res_scale=s, relu=True,
                     out_scale=j["out"])
        s = j["out"]
    return flips, codes


def test_int8_trunk_equals_jax_with_its_tree(trunk):
    """med_tpu's quantized tree carried across: the accumulators of every
    conv equal, the codes equal but for counted tie flips, and the features
    of the whole forward within 1e-5 of the largest where none flipped."""
    ss, x, jqt = trunk["ss"], trunk["x"], trunk["jqt"]
    carried = load_jax_quant_trunk(jqt, ss)
    flips, codes = _lockstep(jqt, carried, x, ss)
    assert flips <= FLIP_FRAC * codes, (flips, codes)
    want = np.asarray(jax.jit(lambda q, a: jq.resnet50_int8_apply(q, a, stage_sizes=ss))(
        jqt, x))
    got = tq.resnet50_int8_apply(carried, _t(x), ss).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if flips == 0:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        print(f"{flips} of {codes} codes flipped; features moved "
              f"{np.abs(got - want).max() / np.abs(want).max():.3g} of the largest")


def _drift(got, ref):
    cos = np.sum(got * ref, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    return cos, np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_own_int8_trunk_within_the_drift_bounds(trunk):
    """The port's quantize -> apply against the fp32 trunk: cosine > 0.99 and
    rel < 0.08 at (1, 1, 1, 1); > 0.985 and < 0.12 at (2, 2, 2, 2), as
    tests/test_quant.py holds med_tpu's."""
    got = tq.resnet50_int8_apply(trunk["tqt"], _t(trunk["x"]), trunk["ss"]).numpy()
    cos, rel = _drift(got, trunk["ref"])
    bounds = (0.99, 0.08) if trunk["ss"][0] == 1 else (0.985, 0.12)
    assert np.all(cos > bounds[0]), cos
    assert rel < bounds[1], rel


@pytest.fixture(scope="module")
def fe():
    model = JaxFE()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 10, 2048)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda: model.init(jax.random.key(0), x[:1]))())
    return model, params, x


def test_int8_fe_matches_jax_and_stays_within_drift(fe):
    """Scales at rtol 1e-6; with med_tpu's tree carried across the outputs
    within 1e-5 of the largest; the port's own within cosine 0.995 and rel
    0.05 of the fp32 FE, on the calibration batch and an unseen one; the
    int8 feature store bit-identical to the fp32 input."""
    model, params, x = fe
    jqfe = jax.device_get(jq.quantize_fe(params["params"], x[:4]))
    qfe = tq.quantize_fe(params["params"], x[:4])
    carried = load_jax_quant_fe(jqfe)
    for a, b in zip(qfe["layers"], carried["layers"]):
        assert torch.equal(a["wq"], b["wq"])
        np.testing.assert_allclose(a["in_scale"].numpy(), b["in_scale"].numpy(), rtol=1e-6)
    unseen = np.random.default_rng(1).normal(size=(8, 10, 2048)).astype(np.float32)
    for batch in (x, unseen):
        want = np.asarray(jq.fe_int8_apply(jqfe, batch))
        got = tq.fe_int8_apply(carried, _t(batch)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        ref = np.asarray(model.apply(params, batch), np.float32)
        own = tq.fe_int8_apply(qfe, _t(batch)).numpy()
        assert own.shape == ref.shape and own.dtype == np.float32
        cos, rel = _drift(own, ref)
        assert np.all(cos > 0.995), cos.min()
        assert rel < 0.05, rel
        store = tq.quantize_fe_input(qfe, _t(batch))
        assert store.dtype == torch.int8
        assert torch.equal(tq.fe_int8_apply(qfe, store), tq.fe_int8_apply(qfe, _t(batch)))


def test_quantize_fe_applies_eleven_hidden_layers_in_numeric_order():
    """dense0 .. dense10: a string sort would put dense10 before dense2
    (med_tpu sorts so); the port applies them by number, as the fp32 FE."""
    rng = np.random.default_rng(3)
    dims = [16] + list(range(15, 4, -1)) + [4]
    names = [f"dense{i}" for i in range(11)] + ["out"]
    params = {n: {"kernel": (rng.normal(size=(dims[i], dims[i + 1])) /
                             np.sqrt(dims[i])).astype(np.float32),
                  "bias": rng.normal(size=dims[i + 1]).astype(np.float32) * 0.1}
              for i, n in enumerate(names)}
    x = rng.normal(size=(6, 5, 16)).astype(np.float32)
    qfe = tq.quantize_fe(params, x)
    assert [tuple(layer["wq"].shape) for layer in qfe["layers"]] == \
        [(dims[i + 1], dims[i]) for i in range(12)]
    ref = x
    for i, n in enumerate(names):
        ref = ref @ params[n]["kernel"] + params[n]["bias"]
        if i < 11:
            ref = np.maximum(ref, 0)
    cos, rel = _drift(tq.fe_int8_apply(qfe, _t(x)).numpy(), ref)
    assert rel < 0.1 and np.all(cos > 0.99), (rel, cos.min())


def test_int8_front_end_matches_jax_with_shared_scales(tmp_path, rng):
    """PixelFrontEnd(int8=True) of both packages from one fine-tune
    checkpoint (fold pixel statistics in its meta), the port's trunk tree
    replaced by med_tpu's calibration: features at 1e-5 of the largest."""
    model = JaxResNet50((1, 1, 1, 1), 8, jnp.float32)
    v = jax.device_get(jax.jit(lambda: model.init(jax.random.key(0),
                                                  jnp.zeros((1, 40, 40, 3))))())
    mean, std = np.full(3, 0.5, np.float32), np.full(3, 0.25, np.float32)
    path = str(tmp_path / "resnet50_1Out.npz")
    jckpt.save_checkpoint(path, {"trunk": v["params"]}, {"trunk": v["batch_stats"]},
                          meta={"mean": mean.tolist(), "std": std.tolist()})
    frames = rng.integers(0, 256, size=(11, 40, 40, 3)).astype(np.uint8)
    kw = dict(int8=True, calib_frames=frames[:4], stage_sizes=(1, 1, 1, 1), width=8,
              batch_size=8)
    want = JaxFrontEnd.from_checkpoint(path, **kw).features(frames)
    fe = PixelFrontEnd.from_checkpoint(path, device="cpu", **kw)
    own = fe.features(frames)
    pix = (frames[:4].astype(np.float32) / 255.0 - mean) / std
    jqt = jax.device_get(jq.quantize_resnet50_trunk(v, pix, stage_sizes=(1, 1, 1, 1)))
    fe.qt = load_jax_quant_trunk(jqt, (1, 1, 1, 1))
    got = fe.features(frames)
    assert got.shape == (11, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    cos, _ = _drift(own, want)
    assert np.all(cos > 0.99), cos


def test_front_end_refuses_a_mean_without_a_std(tmp_path, rng):
    """A mean given without a std (or a std without a mean) raises, through
    the constructor and through a checkpoint meta that holds one of the
    two; med_tpu crashes there unclearly, and before the repair the port
    standardised by std = nan and returned NaN features."""
    from med_tpu_torch.models.layers import init_weights
    from med_tpu_torch.models.resnet import ResNet50
    from med_tpu_torch.utils.jax_params import export_jax_params

    net = ResNet50((1, 1, 1, 1), 8, torch.float32)
    init_weights(net, torch.Generator().manual_seed(0))
    v = export_jax_params(net)
    kw = dict(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="a mean without a std"):
        PixelFrontEnd(v["params"], v["batch_stats"], mean=[0.5] * 3, **kw)
    with pytest.raises(ValueError, match="a std without a mean"):
        PixelFrontEnd(v["params"], v["batch_stats"], std=[0.25] * 3, **kw)
    path = str(tmp_path / "resnet50_1Out.npz")
    jckpt.save_checkpoint(path, {"trunk": v["params"]}, {"trunk": v["batch_stats"]},
                          meta={"mean": [0.5] * 3})
    with pytest.raises(ValueError, match="a mean without a std"):
        PixelFrontEnd.from_checkpoint(path, **kw)
    frames = rng.integers(0, 256, size=(3, 40, 40, 3)).astype(np.uint8)
    fe = PixelFrontEnd.from_checkpoint(path, std=[0.25] * 3, **kw)
    assert np.isfinite(fe.features(frames)).all()
