"""Video feature compressor: MLP 2048 -> 512 -> 256 -> video_dims (port of
``med_tpu.models.feature_extractor``; reference models.py:6-47). Under
tensor parallelism (``parallel/mesh.py``) ``dense0`` holds this rank's
output columns and ``dense1`` its input rows: their partial product is
summed over ``tp_group`` before ``dense1``'s bias."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.comm import psum
from .layers import Dense


class FeatureExtractor(nn.Module):
    def __init__(self, output_dim: int = 32, in_dim: int = 2048,
                 hidden_dims: Sequence[int] = (512, 256)):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        for i in range(len(hidden_dims)):
            self.add_module(f"dense{i}", Dense(dims[i], dims[i + 1]))
        self.n_hidden = len(hidden_dims)
        self.out = Dense(dims[-1], output_dim)
        self.tp_group = None

    def forward(self, x):
        for i in range(self.n_hidden):
            layer = getattr(self, f"dense{i}")
            if i == 1 and self.tp_group is not None:
                x = psum(F.linear(x, layer.weight), self.tp_group) + layer.bias
            else:
                x = layer(x)
            x = torch.relu(x)
        return self.out(x)
