"""TeCNo: multi-stage temporal convolutional network at frame level (port of
``med_tpu.models.tcn``; reference ``MultiStageModel``, models_TCN.py:17-101).

Stage 0 maps the (B, T, in_dim) feature stream to class logits through
``num_layers`` dilated residual layers at ``f_maps`` channels; each later
stage refines the softmax of the stage before. The output is every stage's
logits stacked, (S, B, T, out_classes); the loss averages over the stages.
Each stage's stack is one call of the TCN kernel (K2b) on the card, and its
backward one call of K5 where autograd needs it. With ``dtype=torch.bfloat16``
the stages compute in bfloat16 through the plain layer loop, as ``med_tpu``'s
unfused TeCNo does, with float32 logits.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .layers import SingleStageTCN


class TeCNo(nn.Module):
    """Stages ``stage0`` .. ``stage{S-1}``, the flax module's names."""

    def __init__(self, num_stages: int = 2, num_layers: int = 8, f_maps: int = 64,
                 in_dim: int = 2048, out_classes: int = 2, causal: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_stages = num_stages
        for s in range(num_stages):
            self.add_module(f"stage{s}", SingleStageTCN(
                num_layers, in_dim if s == 0 else out_classes, f_maps, out_classes,
                causal, dtype=dtype))

    def stages(self):
        return [getattr(self, f"stage{s}") for s in range(self.num_stages)]

    def dropout_masks(self, T: int, generator: torch.Generator,
                      B: int = 1) -> Dict[str, Dict[str, torch.Tensor]]:
        """One training forward's dropout masks, by stage name, in COG's
        layout: {"stage<s>": {"stack": (L, B, T, C) uint8}}, drawn from
        ``generator`` on the model's device."""
        return {f"stage{s}": {"stack": stage.stack.dropout_mask(B, T, generator)}
                for s, stage in enumerate(self.stages())}

    def forward(self, x, train: bool = False, masks=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, in_dim) -> (num_stages, B, T, out_classes). ``train``
        applies dropout with ``masks`` (:meth:`dropout_masks`' layout), or
        with masks drawn from ``generator`` when none are given."""
        if train and masks is None:
            if generator is None:
                raise ValueError("a training forward needs masks or a generator")
            masks = self.dropout_masks(x.shape[1], generator, x.shape[0])
        outputs, h = [], x
        for s, stage in enumerate(self.stages()):
            _, logits = stage(h, masks[f"stage{s}"]["stack"] if train else None)
            outputs.append(logits)
            h = torch.softmax(logits, dim=-1)
        return torch.stack(outputs)
