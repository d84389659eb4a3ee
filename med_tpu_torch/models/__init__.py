"""Model factory (port of ``med_tpu.models``). COG only so far; the other
families are queued in ROADMAP.md."""

from __future__ import annotations

from typing import Optional

from ..config import ExperimentConfig
from .cog import COG
from .feature_extractor import FeatureExtractor
from .layers import init_weights  # noqa: F401

_QUEUED = {
    "SimpleCNN": "Queue A7 (window families)",
    "SimpleLSTM": "Queue A7 (window families)",
    "Siamese_CNN": "Queue A7 (window families)",
    "Siamese_LSTM": "Queue A7 (window families)",
    "TeCNo": "Queue A6 (other frame families)",
    "TransSVNet": "Queue A6 (other frame families)",
}


def build_model(cfg: ExperimentConfig, prompt_path: Optional[str] = None) -> COG:
    """Construct the configured model, with zero weights (load or
    :func:`init_weights` them)."""
    name = cfg.model_name
    if name != "COG":
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md {_QUEUED[name]}")
    if cfg.SRM or cfg.use_skill_prompt or not cfg.use_all_gestures:
        raise NotImplementedError(
            "COG's SRM, skill-prompt and observed-gesture variants are not "
            "ported yet: ROADMAP.md Queue A6 (other frame families)")
    if cfg.compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' (bf16 matmuls) is not ported yet: the "
            "port trains and serves in float32; ROADMAP.md Queue A6")
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
