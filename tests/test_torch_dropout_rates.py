"""TCN dropout at rates other than 0.5 in the port, and med_tpu's public
package names, on the CPU at a small size (L = 3, C = 8, T = 64, B = 2)
with the same numpy-seeded inputs, weights and keep-masks on both sides:

- ``ResidualStack(dropout_rate=r)`` for r in {0.3, 0.7} against med_tpu's
  ``ResidualStack(dropout_rate=r)``, the mask injected into JAX through
  ``flax.linen.intercept_methods``: the forward at rtol 1e-5, atol 1e-6 of
  the largest |value|; every gradient (``jax.grad``) within 1e-5 of its
  own largest |value|, the relu patterns of the two forwards pinned equal;
- the plain versions ``dilated_stack_xla`` and ``_stages_bwd_plain`` (the
  layer loop of ``_layer_bwd_plain``) at ``scale = 1 / (1 - r)`` against
  the same JAX module;
- the port's draw: None at rate 0, rate 0.5's bit-unpacked words as before,
  a keep fraction within 4 sigma of 1 - r at r = 0.3, and rates 1.0 and
  -0.1 refused;
- ``select_error_labels`` against med_tpu's on window and frame powersets;
- every name that med_tpu's package ``__init__``s export resolves in the
  port's same package.
"""

import ast
import importlib
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from med_tpu.config import ERROR_TYPE_TO_COLUMN
from med_tpu.data.labels import select_error_labels as jax_select_error_labels
from med_tpu.models.layers import ResidualStack as JaxResidualStack
from med_tpu_torch.data.labels import select_error_labels
from med_tpu_torch.models.layers import ResidualStack, SingleStageTCN, keep_scale
from med_tpu_torch.ops import tcn_fused as ttcn
from med_tpu_torch.utils.jax_params import load_jax_params

ROOT = Path(__file__).resolve().parent.parent
L, C, T, B = 3, 8, 64, 2
RATES = [0.3, 0.7]


def _close(got, want, name, rtol=1e-5, frac=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


def _case(rate):
    """med_tpu's stack at ``rate``, its params, and the seeded x, output
    cotangent and (L, B, T, C) Bernoulli(1 - rate) keep-mask."""
    rng = np.random.default_rng(int(rate * 100))
    model = JaxResidualStack(num_layers=L, channels=C, dropout_rate=rate, fused=False)
    params = model.init(jax.random.key(int(rate * 10)), jnp.zeros((B, T, C)))["params"]
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    g = rng.normal(size=(B, T, C)).astype(np.float32)
    mask = (rng.random((L, B, T, C)) < 1.0 - rate).astype(np.uint8)
    return model, jax.device_get(params), x, g, mask


def _jax_apply(model, params, x, mask, relu_patterns=None):
    """med_tpu's training forward with ``mask`` injected; with
    ``relu_patterns`` (a list) it records each layer's relu pattern."""
    def intercept(next_fun, args, kwargs, context):
        if context.method_name == "dropout_mask":
            return jnp.asarray(mask)
        return next_fun(*args, **kwargs)

    relu = nn.relu

    def recording_relu(y):
        relu_patterns.append(np.asarray(y) > 0)
        return relu(y)

    with nn.intercept_methods(intercept):
        if relu_patterns is None:
            return model.apply({"params": params}, x, train=True,
                               rngs={"dropout": jax.random.key(0)})
        nn.relu = recording_relu
        try:
            return model.apply({"params": params}, x, train=True,
                               rngs={"dropout": jax.random.key(0)})
        finally:
            nn.relu = relu


def _jax_grads(model, params, x, g, mask):
    def f(p, xx):
        return jnp.sum(_jax_apply(model, p, xx, mask) * g)

    return jax.device_get(jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x)))


def _port_stack(params, rate):
    stack = ResidualStack(L, C, dropout_rate=rate)
    state, _ = load_jax_params({"params": params}, stack)
    stack.load_state_dict(state, strict=True)
    return stack


def _port_relu_patterns(stack, x, mask):
    """Each layer's (B, T, C) relu pattern of the port's forward."""
    per_trial = []
    for b in range(B):
        saved = []
        ttcn.dilated_stack_xla(torch.from_numpy(x[b]), *stack.weights(),
                               mask=torch.from_numpy(mask[:, b]), saved=saved,
                               scale=keep_scale(stack.dropout_rate))
        per_trial.append([y.detach().numpy() > 0 for _, y in saved])
    return [np.stack([p[i] for p in per_trial]) for i in range(L)]


@pytest.mark.parametrize("rate", RATES)
def test_residual_stack_matches_med_tpu_at_the_rate(rate):
    model, params, x, g, mask = _case(rate)
    patterns = []
    want = _jax_apply(model, params, jnp.asarray(x), mask, patterns)
    stack = _port_stack(params, rate)
    xt = torch.from_numpy(x).requires_grad_()
    got = stack(xt, torch.from_numpy(mask))
    _close(got, want, "forward")
    for i, (p, q) in enumerate(zip(_port_relu_patterns(stack, x, mask), patterns)):
        assert np.array_equal(p, q), f"layer {i}: relu patterns differ"

    (got * torch.from_numpy(g)).sum().backward()
    want_p, want_x = _jax_grads(model, params, x, g, mask)
    _close(xt.grad, want_x, "dx", frac=1e-5)
    for k in ("w3", "b3", "w1", "b1"):
        _close(getattr(stack, k).grad, want_p[k], k, frac=1e-5)


@pytest.mark.parametrize("rate", RATES)
def test_plain_versions_at_the_keep_scale_match_med_tpu(rate):
    model, params, x, g, mask = _case(rate)
    want = _jax_apply(model, params, jnp.asarray(x), mask)
    want_p, want_x = _jax_grads(model, params, x, g, mask)
    scale = keep_scale(rate)
    w = [torch.from_numpy(np.array(params[k])) for k in ("w3", "b3", "w1", "b1")]
    dws = []
    for b in range(B):
        m = torch.from_numpy(mask[:, b])
        saved = []
        out = ttcn.dilated_stack_xla(torch.from_numpy(x[b]), *w, mask=m, saved=saved,
                                     scale=scale)
        _close(out, want[b], f"trial {b} forward")
        h_saved = torch.stack([h for h, _ in saved])
        y_saved = torch.stack([y for _, y in saved])
        dx, (dw,) = ttcn._stages_bwd_plain(torch.from_numpy(g[b])[None], h_saved, y_saved,
                                           [(w[0], w[2])], [m], True, scale)
        _close(dx, want_x[b], f"trial {b} dx", frac=1e-5)
        dws.append(dw)
    for k, got in zip(("w3", "b3", "w1", "b1"), (sum(t) for t in zip(*dws))):
        _close(got, want_p[k], k, frac=1e-5)


def test_port_draw_at_each_rate():
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    assert ResidualStack(L, C, dropout_rate=0.0).dropout_mask(B, T, gen()) is None
    # rate 0.5: one random bit an element, unpacked along T
    words = torch.randint(0, 2 ** 32, (L, B, 2, 1, C), generator=gen(), dtype=torch.int64)
    bits = (words >> torch.arange(32).reshape(1, 1, 1, 32, 1)) & 1
    want = bits.reshape(L, B, 64, C)[:, :, :50].to(torch.uint8)
    got = ResidualStack(L, C).dropout_mask(B, 50, gen())
    assert got.dtype == torch.uint8 and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # any other rate: Bernoulli(1 - rate), contiguous uint8
    stack = ResidualStack(L, C, dropout_rate=0.3)
    m = stack.dropout_mask(B, 4096, gen())
    assert m.shape == (L, B, 4096, C) and m.dtype == torch.uint8 and m.is_contiguous()
    assert set(torch.unique(m).tolist()) == {0, 1}
    n = m.numel()
    assert abs(m.double().mean().item() - 0.7) < 4 * np.sqrt(0.7 * 0.3 / n)
    torch.testing.assert_close(stack.dropout_mask(B, 4096, gen()), m, rtol=0, atol=0)
    assert ResidualStack(L, C).dropout_mask(B, T, gen(), rate=0.3).shape == (L, B, T, C)
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout rate"):
            ResidualStack(L, C, dropout_rate=bad)
        with pytest.raises(ValueError, match="dropout rate"):
            SingleStageTCN(L, 4, C, 2, dropout_rate=bad)
        with pytest.raises(ValueError, match="dropout rate"):
            ResidualStack(L, C).dropout_mask(B, T, gen(), rate=bad)
    assert keep_scale(0.0) == 1.0 and keep_scale(0.5) == 2.0


def test_single_stage_passes_its_rate_to_the_stack():
    stage = SingleStageTCN(L, 4, C, 2, dropout_rate=0.3)
    assert stage.stack.dropout_rate == 0.3
    assert SingleStageTCN(L, 4, C, 2).stack.dropout_rate == 0.5


@pytest.mark.parametrize("dataset_type", ["window", "frame"])
def test_select_error_labels_matches_med_tpu(rng, dataset_type):
    shape = (40, 7) if dataset_type == "window" else (3, 20, 7)
    e = rng.integers(0, 2, size=shape).astype(np.int32)
    for error_type in ERROR_TYPE_TO_COLUMN:
        want = jax_select_error_labels(e, error_type, dataset_type)
        got = select_error_labels(e, error_type, dataset_type)
        assert got.dtype == want.dtype and np.array_equal(got, want), error_type
    for fn in (select_error_labels, jax_select_error_labels):
        with pytest.raises(ValueError, match="not supported"):
            fn(e, "bogus", dataset_type)
    with pytest.raises(ValueError, match="dataset_type"):
        select_error_labels(e, "global", "clip")


def _exported(init: Path):
    """The names a package ``__init__`` binds from the package's own modules
    (relative imports, submodules) and defines (functions, classes)."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("package", ["", "ops", "models", "data", "eval", "parallel", "viz"])
def test_med_tpus_package_names_resolve_in_the_port(package):
    init = ROOT / "med_tpu" / package / "__init__.py"
    names = _exported(init)
    module = importlib.import_module("med_tpu_torch" + (f".{package}" if package else ""))
    missing = sorted(n for n in names if not hasattr(module, n))
    assert not missing, f"med_tpu_torch.{package} lacks {missing}"
