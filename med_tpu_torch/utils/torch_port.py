"""Reference-checkpoint interop: import the reference's torch state_dicts
(the port's copy of the COG part of ``med_tpu.utils.torch_port``).

The reference saves ``{'feature_extractor': state_dict, 'model':
state_dict}`` per fold (modeling_utils.py:3028-3040). The importers here map
those onto the same nested tree that ``med_tpu``'s importer returns (the
``med_tpu`` checkpoint layout), so an imported checkpoint goes through
:func:`med_tpu_torch.utils.jax_params.load_jax_params` like any other.

Layout conversions: Linear (O, I) -> kernel (I, O); Conv1d (O, I, K) ->
kernel (K, I, O); a TCN stage's per-layer convs are stacked (L, ...).
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


def import_reference_checkpoint(path: str, model_name: str) -> dict:
    """Load a reference ``best_model_*.pt`` into the ``med_tpu`` checkpoint
    layout ({'params': {'fe': ..., 'model': ...}, 'batch_stats': {'model':
    ...}, and 'constants': {'model': ...} for COG's frozen prompt tables}).
    COG only: the other families' importers come with their models."""
    if model_name in ("TeCNo", "TransSVNet"):
        raise NotImplementedError(
            f"importing a reference {model_name} checkpoint is not ported yet: "
            "ROADMAP.md Queue A6 (other frame families)")
    if model_name in ("SimpleCNN", "Siamese_CNN", "SimpleLSTM", "Siamese_LSTM"):
        raise NotImplementedError(
            f"importing a reference {model_name} checkpoint is not ported yet: "
            "ROADMAP.md Queue A7 (window families)")
    if model_name != "COG":
        raise ValueError(f"unknown reference model name {model_name!r}")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    if blob.get("feature_extractor"):
        out["params"]["fe"] = import_feature_extractor(blob["feature_extractor"])
    p, s, constants = import_cog(blob["model"])
    out["params"]["model"] = p
    out["batch_stats"]["model"] = s
    if constants:
        out["constants"] = {"model": constants}
    return out
