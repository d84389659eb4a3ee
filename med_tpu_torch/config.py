"""Experiment configuration: ``med_tpu.config.ExperimentConfig``'s fields
with the same names and defaults, so that the ``params.json`` of a run of
either package can be compared key by key. A field that selects behaviour
the port does not have yet is kept as data here and raises where it is used,
naming its ROADMAP item."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

# The raw per-frame label vector's 5 columns
# (reference MED/dataset/preprocessing_utils.py:686-693).
RAW_ERROR_COLUMNS = (
    "Out_Of_View",
    "Needle_Drop",
    "Multiple_Attempts",
    "Needle_Position",
    "Error",  # global any-error flag
)

# error_type -> column in the powerset label matrix
# (reference MED/modeling/modeling_utils.py:161-170).
ERROR_TYPE_TO_COLUMN = {
    "No Error": 0,
    "Out_Of_View": 1,
    "Multiple_Attempts": 2,
    "Needle_Position": 3,
    "Out_Of_View_Multiple_Attempts": 4,
    "Multiple_Attempts_Needle_Position": 5,
    "global": -1,
    "all_errors": (0, 1, 2, 3, 4, 5),
}

# Subject letter -> skill level (reference MED/dataset/CustomFrameDataset.py:26-34).
SKILL_LEVELS = {
    "B": "Novice", "C": "Intermediate", "D": "Expert", "E": "Expert",
    "F": "Intermediate", "G": "Novice", "H": "Novice", "I": "Expert",
}
SKILL_ORDER = ("Novice", "Intermediate", "Expert")

# LOSO folds (supertrial-out; reference train_window.ipynb cell 1 `out1`).
LOSO_FOLDS = ("1Out", "2Out", "3Out", "4Out", "5Out")

MODEL_NAMES = (
    "SimpleCNN", "SimpleLSTM", "Siamese_CNN", "Siamese_LSTM",
    "TeCNo", "TransSVNet", "COG", "MiMoV2Flash",
)


def compute_window_size_stride(frequency: int = 30) -> Tuple[int, int]:
    """2-second windows with 4/3-second stride at the given sampling rate
    (reference MED/dataset/dataset_utils.py:262-279: 5 Hz -> (10, 6))."""
    return int(2 * frequency), int(4 / 3 * frequency)


@dataclasses.dataclass
class ExperimentConfig:
    """Full experiment configuration (reference ``exp_kwargs`` key set)."""

    # --- task selection ---
    error_type: str = "global"        # 'global' | 'all_errors' | 'sequential' | specific name
    dataset_type: str = "window"      # 'window' | 'frame'
    model_name: str = "SimpleCNN"
    data_type: str = "multimodal"     # 'multimodal' | 'video' | 'kinematics'
    frequency: int = 5                # Hz of the preprocessed data

    # --- optimization ---
    n_epochs: int = 15
    batch_size: int = 512
    lr: float = 5e-4
    weight_decay: float = 5e-3        # L2 added to the gradient (torch Adam)
    lr_scheduler: bool = True         # cosine annealing to 1e-6 over n_epochs
    pos_weight: bool = False          # class-count loss weights: window families
                                      # only; the frame path never reads it
    es_weight_scale: float = 1.5      # window ES family
    loss_or_f1: str = "f1"            # best-checkpoint selection criterion
    seed: int = 42

    # --- heads / dims ---
    out_features: int = 1             # 2 for binary frame models
    video_dims: int = 32              # FeatureExtractor output dim (2048 = bypass)
    num_layers: int = 3               # SimpleLSTM depth
    hidden_size: int = 128            # SimpleLSTM hidden size

    # --- siamese ---
    siamese: bool = False
    n_comparisons: int = 20
    n_pairs: int = 20000

    # --- label handling ---
    delete_ND: bool = False           # drop Needle-Drop frames

    # --- frame models ---
    mstcn_stages: int = 2
    mstcn_layers: int = 8
    mstcn_f_maps: int = 64
    mstcn_f_dim: int = 2048
    mstcn_causal_conv: bool = True
    num_R: int = 3                    # COG refinement stages
    num_layers_R: int = 10
    num_layers_Basic: int = 11
    d_model: int = 64
    d_q: int = 8
    sequence_length: int = 30         # len_q: local attention window
    smooth_lambda: float = 0.15       # COG truncated-MSE smoothing weight
    use_all_gestures: bool = True
    use_skill_prompt: bool = False
    SRM: bool = False                 # skill-reasoning module

    # --- staged pipelines ---
    run_id: Optional[str] = None      # upstream run (TeCNo for TransSVNet)
    use_true_binary_labels_train: bool = True

    # --- bookkeeping ---
    return_train_preds: bool = False
    save_local: bool = False

    # --- the JAX package's device knobs, kept so both packages write the
    # same params.json; the port reads compute_dtype, fused_epoch,
    # fused_run, trial_batch and max_frames ---
    compute_dtype: str = "float32"    # "bfloat16": the TCN paths compute in bf16
    mesh_shape: Optional[Tuple[int, ...]] = None
    use_pallas: bool = True
    prefetch_depth: int = 2
    fused_epoch: bool = True          # frame folds: every trial padded to one
                                      # common bucket (the per-trial loop runs)
    fused_run: bool = True
    trial_batch: int = 1              # frame families: trials per step (groups
                                      # padded with zero-weight repeats)
    max_frames: int = 4096            # frame-model padding bucket ceiling
    flat_params: bool = False
    fold_pad_quantum: int = 512

    def __post_init__(self):
        if self.model_name not in MODEL_NAMES:
            raise ValueError(f"unknown model_name {self.model_name!r}; one of {MODEL_NAMES}")
        if self.data_type not in ("multimodal", "video", "kinematics"):
            raise ValueError(f"unknown data_type {self.data_type!r}")
        if self.dataset_type not in ("window", "frame"):
            raise ValueError(f"unknown dataset_type {self.dataset_type!r}")
        if self.error_type not in ERROR_TYPE_TO_COLUMN and self.error_type != "sequential":
            raise ValueError(f"unknown error_type {self.error_type!r}")

    @property
    def window_size(self) -> int:
        return compute_window_size_stride(self.frequency)[0]

    @property
    def stride(self) -> int:
        return compute_window_size_stride(self.frequency)[1]

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["window_size"] = self.window_size
        d["stride"] = self.stride
        d["in_features"] = self.in_features()
        return d

    def in_features(self) -> int:
        """Model input width per data_type (reference ``in_features_dict``)."""
        video = self.video_dims
        return {"multimodal": video + 26, "video": video, "kinematics": 26}[self.data_type]

    def uses_feature_extractor(self) -> bool:
        """The 2048->video_dims MLP is used unless kinematics-only or raw
        2048-d features are fed directly (reference modeling_utils.py:58-75)."""
        return self.data_type != "kinematics" and self.video_dims != 2048


def run_config(run_dir: str) -> ExperimentConfig:
    """A stored run's ``ExperimentConfig`` from its ``params.json`` (a run of
    either package; keys the config does not have are left out)."""
    with open(os.path.join(run_dir, "params.json")) as f:
        params = json.load(f)
    return ExperimentConfig(**{k: v for k, v in params.items()
                               if k in ExperimentConfig.__dataclass_fields__})
