"""Model factory (port of ``med_tpu.models``): the frame families COG (with
its observed-gesture, skill-prompt and SRM variants), TeCNo and
TransSVNet, in float32 or with ``compute_dtype="bfloat16"``, MiMo-V2-Flash's
hybrid block over frames (float32; the port's own, with no JAX
counterpart; its sizes a :class:`MiMoArch`), and the window
families SimpleCNN, SimpleLSTM, Siamese_CNN and Siamese_LSTM (float32 alone:
``compute_dtype`` does not reach them, as in ``med_tpu``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..config import ExperimentConfig
from .cog import COG
from .feature_extractor import FeatureExtractor
from .layers import init_weights  # noqa: F401
from .mimo import MiMoArch, MiMoV2Flash
from .tcn import TeCNo
from .transsvnet import TransSVNet
from .window_models import (  # noqa: F401
    SiameseCNN,
    SiameseLSTM,
    WindowCNN,
    WindowLSTM,
    window_model,
)


def compute_dtype(cfg: ExperimentConfig) -> Optional[torch.dtype]:
    """The TCN paths' compute type: None (float32) or torch.bfloat16."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def build_tecno(cfg: ExperimentConfig, dtype: Optional[torch.dtype] = None) -> TeCNo:
    """TeCNo at the config's mstcn_* sizes: the model of the TeCNo family,
    and, in float32 whatever the config's compute type (as med_tpu builds
    it), the frozen stage under TransSVNet (reference
    modeling_utils.py:2263-2268)."""
    return TeCNo(num_stages=cfg.mstcn_stages, num_layers=cfg.mstcn_layers,
                 f_maps=cfg.mstcn_f_maps, in_dim=cfg.in_features(),
                 out_classes=cfg.out_features, causal=cfg.mstcn_causal_conv,
                 dtype=dtype)


def build_model(cfg: ExperimentConfig, prompt_path: Optional[str] = None,
                arch: Optional[MiMoArch] = None) -> nn.Module:
    """Construct the configured model, with zero weights (load or
    :func:`init_weights` them). ``arch``: MiMoV2Flash's sizes (the published
    widths and this chip's cut when None), its input width the config's."""
    name = cfg.model_name
    if name == "MiMoV2Flash":
        arch = arch or MiMoArch()
        return MiMoV2Flash(dataclasses.replace(arch, in_dim=cfg.in_features(),
                                               out_classes=cfg.out_features))
    window = window_model(name, cfg.in_features(), cfg.window_size, cfg.out_features,
                          cfg.hidden_size, cfg.num_layers)
    if window is not None:
        return window
    if name == "TeCNo":
        return build_tecno(cfg, compute_dtype(cfg))
    if name == "TransSVNet":
        return TransSVNet(f_maps=cfg.mstcn_f_maps, out_classes=cfg.out_features,
                          len_q=cfg.sequence_length, in_dim=cfg.in_features())
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
        use_all_gestures=cfg.use_all_gestures,
        use_skill_prompt=cfg.use_skill_prompt,
        srm=cfg.SRM,
        dtype=compute_dtype(cfg),
    )


def build_feature_extractor(cfg: ExperimentConfig) -> Optional[FeatureExtractor]:
    """The 2048->video_dims MLP, when the config uses one."""
    if not cfg.uses_feature_extractor():
        return None
    return FeatureExtractor(output_dim=cfg.video_dims)
