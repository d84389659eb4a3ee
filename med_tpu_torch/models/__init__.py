"""Model factory (port of ``med_tpu.models``): the frame families COG,
TeCNo and TransSVNet; the window families are queued in ROADMAP.md."""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from ..config import ExperimentConfig
from .cog import COG
from .feature_extractor import FeatureExtractor
from .layers import init_weights  # noqa: F401
from .tcn import TeCNo
from .transsvnet import TransSVNet

_QUEUED = {
    "SimpleCNN": "Queue A7 (window families)",
    "SimpleLSTM": "Queue A7 (window families)",
    "Siamese_CNN": "Queue A7 (window families)",
    "Siamese_LSTM": "Queue A7 (window families)",
}


def build_tecno(cfg: ExperimentConfig) -> TeCNo:
    """TeCNo at the config's mstcn_* sizes: the model of the TeCNo family,
    and the frozen stage under TransSVNet (reference
    modeling_utils.py:2263-2268)."""
    return TeCNo(num_stages=cfg.mstcn_stages, num_layers=cfg.mstcn_layers,
                 f_maps=cfg.mstcn_f_maps, in_dim=cfg.in_features(),
                 out_classes=cfg.out_features, causal=cfg.mstcn_causal_conv)


def build_model(cfg: ExperimentConfig, prompt_path: Optional[str] = None) -> nn.Module:
    """Construct the configured model, with zero weights (load or
    :func:`init_weights` them)."""
    name = cfg.model_name
    if name in _QUEUED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md {_QUEUED[name]}")
    if cfg.compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' (bf16 matmuls) is not ported yet: the "
            "port trains and serves in float32; ROADMAP.md Queue A6")
    if name == "TeCNo":
        return build_tecno(cfg)
    if name == "TransSVNet":
        return TransSVNet(f_maps=cfg.mstcn_f_maps, out_classes=cfg.out_features,
                          len_q=cfg.sequence_length, in_dim=cfg.in_features())
    if cfg.SRM or cfg.use_skill_prompt or not cfg.use_all_gestures:
        raise NotImplementedError(
            "COG's SRM, skill-prompt and observed-gesture variants are not "
            "ported yet: ROADMAP.md Queue A6 (other frame families)")
    return COG(
        num_layers_basic=cfg.num_layers_Basic,
        num_layers_r=cfg.num_layers_R,
        num_r=cfg.num_R,
        f_maps=cfg.mstcn_f_maps,
        f_dim=cfg.in_features(),
        out_classes=cfg.out_features,
        causal=cfg.mstcn_causal_conv,
        d_model=cfg.d_model,
        d_q=cfg.d_q,
        len_q=cfg.sequence_length,
        prompt_path=prompt_path,
    )


def build_feature_extractor(cfg: ExperimentConfig) -> Optional[FeatureExtractor]:
    """The 2048->video_dims MLP, when the config uses one."""
    if not cfg.uses_feature_extractor():
        return None
    return FeatureExtractor(output_dim=cfg.video_dims)
