"""Reference-checkpoint interop: import the reference's torch state_dicts
(the port's copy of ``med_tpu.utils.torch_port``: the window models, COG,
TeCNo and TransSVNet).

The reference saves ``{'feature_extractor': state_dict, 'model':
state_dict}`` per fold (modeling_utils.py:3028-3040). The importers here map
those onto the same nested tree that ``med_tpu``'s importer returns (the
``med_tpu`` checkpoint layout), so an imported checkpoint goes through
:func:`med_tpu_torch.utils.jax_params.load_jax_params` like any other.

Layout conversions: Linear (O, I) -> kernel (I, O); Conv1d (O, I, K) ->
kernel (K, I, O); a TCN stage's per-layer convs are stacked (L, ...); LSTM
gates torch [i, f, g, o] blocks -> flax per-gate kernels, the two torch
biases summed into flax's one; the first dense after the CNN's flatten is
reordered channel-major -> time-major.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _n(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _dense(sd, prefix):
    p = {"kernel": _n(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["bias"] = _n(sd[prefix + ".bias"])
    return p


def _conv1d(sd, prefix):
    return {
        "kernel": _n(sd[prefix + ".weight"]).transpose(2, 1, 0),
        "bias": _n(sd[prefix + ".bias"]),
    }


def import_feature_extractor(sd: Dict[str, Any]) -> dict:
    """FeatureExtractor state_dict -> flax params (dense0, dense1, out)."""
    params = {}
    hidden = sorted(
        int(m.group(1))
        for k in sd
        if (m := re.fullmatch(r"linear\.linear_(\d+)\.weight", k))
    )
    for i in hidden:
        params[f"dense{i}"] = _dense(sd, f"linear.linear_{i}")
    params["out"] = _dense(sd, "linear.output")
    return params


def _bn(sd, prefix):
    return (
        {"scale": _n(sd[prefix + ".weight"]), "bias": _n(sd[prefix + ".bias"])},
        {"mean": _n(sd[prefix + ".running_mean"]),
         "var": _n(sd[prefix + ".running_var"])},
    )


def _sequential_indices(sd: Dict[str, Any], prefix: str):
    """(index, kind) pairs for a torch Sequential: kind in conv/linear/bn."""
    out = {}
    for k in sd:
        m = re.fullmatch(rf"{prefix}\.(\d+)\.weight", k)
        if not m:
            continue
        i = int(m.group(1))
        w = _n(sd[k])
        if f"{prefix}.{i}.running_mean" in sd:
            out[i] = "bn"
        elif w.ndim == 3:
            out[i] = "conv"
        elif w.ndim == 2:
            out[i] = "linear"
    return [out[i] for i in sorted(out)], sorted(out)


def _import_head(sd: Dict[str, Any], params: dict, stats: dict,
                 flatten_channels=None) -> None:
    """The reference's ``linear_layers`` Sequential -> the head's dense{i},
    bn{i} and out. ``flatten_channels``: the CNN's last conv width, whose
    channel-major flatten the first dense's kernel is reordered from."""
    kinds, idxs = _sequential_indices(sd, "linear_layers")
    dense_i = bn_i = 0
    n_linear = sum(1 for k in kinds if k == "linear")
    for kind, i in zip(kinds, idxs):
        if kind == "linear":
            p = _dense(sd, f"linear_layers.{i}")
            if dense_i == 0 and flatten_channels:
                # torch flattened (C, L) channel-major; ours is (L, C)
                w = _n(sd[f"linear_layers.{i}.weight"])  # (out, C*L)
                C = flatten_channels
                L = w.shape[1] // C
                p["kernel"] = w.reshape(w.shape[0], C, L).transpose(2, 1, 0).reshape(
                    L * C, w.shape[0])
            name = "out" if dense_i == n_linear - 1 else f"dense{dense_i}"
            params["head"][name] = p
            dense_i += 1
        else:
            params["head"][f"bn{bn_i}"], stats["head"][f"bn{bn_i}"] = _bn(
                sd, f"linear_layers.{i}")
            bn_i += 1


def import_window_cnn(sd: Dict[str, Any]) -> Tuple[dict, dict]:
    """Reference CNN state_dict -> (params, batch_stats) for WindowCNN."""
    params: Dict[str, Any] = {"head": {}}
    stats: Dict[str, Any] = {"head": {}}
    kinds, idxs = _sequential_indices(sd, "convolutional_layers")
    conv_i = bn_i = 0
    last_conv_channels = None
    for kind, i in zip(kinds, idxs):
        if kind == "conv":
            params[f"conv{conv_i}"] = _conv1d(sd, f"convolutional_layers.{i}")
            last_conv_channels = params[f"conv{conv_i}"]["kernel"].shape[-1]
            conv_i += 1
        else:
            params[f"bn{bn_i}"], stats[f"bn{bn_i}"] = _bn(sd, f"convolutional_layers.{i}")
            bn_i += 1
    _import_head(sd, params, stats, last_conv_channels)
    return params, stats


def import_window_lstm(sd: Dict[str, Any], hidden_size: int = 128) -> Tuple[dict, dict]:
    """Reference LSTM state_dict -> (params, batch_stats) for WindowLSTM."""
    params: Dict[str, Any] = {"head": {}}
    stats: Dict[str, Any] = {"head": {}}
    H = hidden_size
    layer = 0
    while f"lstm.weight_ih_l{layer}" in sd:
        w_ih = _n(sd[f"lstm.weight_ih_l{layer}"])
        w_hh = _n(sd[f"lstm.weight_hh_l{layer}"])
        b = _n(sd[f"lstm.bias_ih_l{layer}"]) + _n(sd[f"lstm.bias_hh_l{layer}"])
        cell = {}
        for gi, g in enumerate("ifgo"):
            sl = slice(gi * H, (gi + 1) * H)
            cell[f"i{g}"] = {"kernel": w_ih[sl].T}
            cell[f"h{g}"] = {"kernel": w_hh[sl].T, "bias": b[sl]}
        params[f"lstm{layer}"] = {"cell": cell}
        layer += 1
    _import_head(sd, params, stats)
    return params, stats


def _dense_nb(sd, prefix):
    """Bias-free torch Linear -> flax Dense kernel."""
    return {"kernel": _n(sd[prefix + ".weight"]).T}


def _ln(sd, prefix):
    return {"scale": _n(sd[prefix + ".weight"]), "bias": _n(sd[prefix + ".bias"])}


def _conv(sd, prefix):
    """torch Conv1d -> our Conv1d (wrapping _TapConv named 'Conv_0')."""
    return {"Conv_0": _conv1d(sd, prefix)}


def _tcn_stage(sd, prefix):
    """One reference TCN stage -> our SingleStageTCN / COGStage params.

    Key contract (models_TCN.py:76-137 SingleStageModel /
    models_COG.py:50-98 SingleStageModel1_COG): optional ``conv_1x1`` input
    conv, ``layers.{i}.conv_dilated`` + ``layers.{i}.conv_1x1`` residual
    blocks, ``conv_out_classes`` classifier conv."""
    p: Dict[str, Any] = {}
    if f"{prefix}.conv_1x1.weight" in sd:
        p["conv_in"] = _conv(sd, f"{prefix}.conv_1x1")
    w3, b3, w1, b1 = [], [], [], []
    i = 0
    while f"{prefix}.layers.{i}.conv_dilated.weight" in sd:
        cd = _conv1d(sd, f"{prefix}.layers.{i}.conv_dilated")
        c1 = _conv1d(sd, f"{prefix}.layers.{i}.conv_1x1")
        w3.append(cd["kernel"])          # (3, C, C)
        b3.append(cd["bias"])
        w1.append(c1["kernel"][0])       # (1, C, C) -> (C, C)
        b1.append(c1["bias"])
        i += 1
    # per-layer residual convs are stored STACKED (models/layers.py
    # ResidualStack: w3 (L,3,C,C), b3 (L,C), w1 (L,C,C), b1 (L,C))
    p["stack"] = {
        "w3": np.stack(w3), "b3": np.stack(b3),
        "w1": np.stack(w1), "b1": np.stack(b1),
    }
    p["conv_out"] = _conv(sd, f"{prefix}.conv_out_classes")
    return p


def _ffn(sd, prefix):
    """PoswiseFeedForwardNet ``fc`` Sequential: Linear/ReLU/Linear
    (models_TCN.py:235-251)."""
    return {
        "Dense_0": _dense_nb(sd, f"{prefix}.fc.0"),
        "Dense_1": _dense_nb(sd, f"{prefix}.fc.2"),
    }


def import_tecno(sd: Dict[str, Any]) -> Tuple[dict, dict]:
    """Reference MultiStageModel state_dict -> TeCNo params.

    ``stage1`` is the first stage, ``stages.{s}`` the refinements
    (models_TCN.py:17-43); ours are ``stage0..stage{S-1}``. No batch norm
    anywhere in the family -> empty batch_stats."""
    p = {"stage0": _tcn_stage(sd, "stage1")}
    s = 0
    while f"stages.{s}.conv_1x1.weight" in sd:
        p[f"stage{s + 1}"] = _tcn_stage(sd, f"stages.{s}")
        s += 1
    return p, {}


def _mha(sd, prefix):
    """Reference MultiHeadAttention (models_TCN.py:196-232): W_Q/W_K/W_V/fc,
    all bias-free; LayerNorm is per-forward => no keys."""
    return {g: _dense_nb(sd, f"{prefix}.{g}") for g in ("W_Q", "W_K", "W_V", "fc")}


def import_transsvnet(sd: Dict[str, Any]) -> Tuple[dict, dict]:
    """Reference Transformer state_dict -> TransSVNet params
    (models_TCN.py:336-385: 1-layer encoder + 1-layer decoder + fc)."""
    p: Dict[str, Any] = {"fc": _dense_nb(sd, "fc")}
    i = 0
    while f"transformer.encoder.layers.{i}.enc_self_attn.W_Q.weight" in sd:
        p[f"enc_attn{i}"] = _mha(sd, f"transformer.encoder.layers.{i}.enc_self_attn")
        p[f"enc_ffn{i}"] = _ffn(sd, f"transformer.encoder.layers.{i}.pos_ffn")
        i += 1
    p["dec_attn"] = _mha(sd, "transformer.decoder.layers.0.dec_enc_attn")
    p["dec_ffn"] = _ffn(sd, "transformer.decoder.layers.0.pos_ffn")
    return p, {}


def _cot(sd, prefix):
    """MyTransformer -> ChainOfGestureTransformer params (models_COG.py:100-176).

    ``enc_self_attn.fc`` / ``atten.fc`` exist in the state_dict but are never
    applied (models_COG.py:46 ``output = context``), so they are deliberately
    not imported — our modules reproduce the quirk and have no such param."""
    p: Dict[str, Any] = {
        "linear1": _dense_nb(sd, f"{prefix}.linear1"),
        "linear2": _dense_nb(sd, f"{prefix}.linear2"),
        "enc_norm": _ln(sd, f"{prefix}.transformer.layer1.norm"),
    }
    i = 0
    while f"{prefix}.transformer.layer1.layers.{i}.norm1.weight" in sd:
        lp = f"{prefix}.transformer.layer1.layers.{i}"
        p[f"layer{i}"] = {
            "norm1": _ln(sd, f"{lp}.norm1"),
            "norm3": _ln(sd, f"{lp}.norm3"),
            **{g: _dense_nb(sd, f"{lp}.enc_self_attn.{g}")
               for g in ("W_Q", "W_K", "W_V")},
            "ffn": _ffn(sd, f"{lp}.pos_ffn"),
        }
        i += 1
    p["atten"] = {
        g: _dense_nb(sd, f"{prefix}.transformer.atten.{g}")
        for g in ("W_Q", "W_K", "W_V")
    }
    return p


def import_cog(sd: Dict[str, Any]) -> Tuple[dict, dict, dict]:
    """Reference COG state_dict -> (params, batch_stats, constants)
    (models_COG.py:261-476: cot [+cot_skill], TCN, Rs, fpn.latlayer1,
    conv_out, fast_stage1, fast_Rs; frozen ``all_action_fea`` prompt table).
    ``fpn.latlayer2/3`` exist but the forward only ever applies latlayer1
    (models_COG.py:217-219), so they are not imported."""
    p: Dict[str, Any] = {"cot": _cot(sd, "cot")}
    if "cot_skill.linear1.weight" in sd:
        p["cot_skill"] = _cot(sd, "cot_skill")
    p["TCN"] = _tcn_stage(sd, "TCN")
    r = 0
    while f"Rs.{r}.conv_out_classes.weight" in sd:
        p[f"R{r}"] = _tcn_stage(sd, f"Rs.{r}")
        r += 1
    p["latlayer1"] = _conv(sd, "fpn.latlayer1")
    p["conv_out"] = _conv(sd, "conv_out")
    p["fast_stage1"] = _tcn_stage(sd, "fast_stage1")
    r = 0
    while f"fast_Rs.{r}.conv_out_classes.weight" in sd:
        p[f"fast_R{r}"] = _tcn_stage(sd, f"fast_Rs.{r}")
        r += 1
    constants: Dict[str, Any] = {}
    if "all_action_fea" in sd:
        constants["gest_embed"] = _n(sd["all_action_fea"])
    if "all_skill_fea" in sd:
        constants["skill_embed"] = _n(sd["all_skill_fea"])
    return p, {}, constants


def import_reference_checkpoint(path: str, model_name: str,
                                hidden_size: int = 128) -> dict:
    """Load a reference ``best_model_*.pt`` into the ``med_tpu`` checkpoint
    layout ({'params': {'fe': ..., 'model': ...}, 'batch_stats': {'model':
    ...}, and 'constants': {'model': ...} for COG's frozen prompt tables}),
    for all seven model families (load paths modeling_utils.py:2241-2329).

    A siamese twin's state dict holds its shared branch's keys; the tree puts
    them under "branch", where the twin's model holds them. (``med_tpu``'s
    importer returns the branch's tree at the top, which its own twins do
    not take.)"""
    window = {"SimpleCNN": import_window_cnn, "Siamese_CNN": import_window_cnn,
              "SimpleLSTM": lambda sd: import_window_lstm(sd, hidden_size),
              "Siamese_LSTM": lambda sd: import_window_lstm(sd, hidden_size)}
    if model_name not in (*window, "COG", "TeCNo", "TransSVNet"):
        raise ValueError(f"unknown reference model name {model_name!r}")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    if blob.get("feature_extractor"):
        out["params"]["fe"] = import_feature_extractor(blob["feature_extractor"])
    constants: Dict[str, Any] = {}
    if model_name in window:
        p, s = window[model_name](blob["model"])
        if model_name.startswith("Siamese"):
            p, s = {"branch": p}, {"branch": s}
    elif model_name == "TeCNo":
        p, s = import_tecno(blob["model"])
    elif model_name == "TransSVNet":
        p, s = import_transsvnet(blob["model"])
    else:
        p, s, constants = import_cog(blob["model"])
    out["params"]["model"] = p
    out["batch_stats"]["model"] = s
    if constants:
        out["constants"] = {"model": constants}
    return out
