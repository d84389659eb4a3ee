"""Experiment configuration: the fields of ``med_tpu.config.ExperimentConfig``
that the frame serving and training paths read, with the same names and
defaults."""

from __future__ import annotations

import dataclasses

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

MODEL_NAMES = (
    "SimpleCNN", "SimpleLSTM", "Siamese_CNN", "Siamese_LSTM",
    "TeCNo", "TransSVNet", "COG",
)


@dataclasses.dataclass
class ExperimentConfig:
    """Configuration of a frame-level experiment (reference ``exp_kwargs``)."""

    error_type: str = "global"        # 'global' | 'all_errors' | 'sequential' | specific name
    dataset_type: str = "window"      # 'window' | 'frame'
    model_name: str = "SimpleCNN"
    data_type: str = "multimodal"     # 'multimodal' | 'video' | 'kinematics'

    # --- optimization ---
    n_epochs: int = 15
    lr: float = 5e-4
    weight_decay: float = 5e-3        # L2 added to the gradient (torch Adam)
    lr_scheduler: bool = True         # cosine annealing to 1e-6 over n_epochs
    pos_weight: bool = False          # CE class weights: not ported, True raises
    loss_or_f1: str = "f1"            # best-checkpoint selection criterion
    seed: int = 42
    siamese: bool = False

    out_features: int = 1             # 2 for binary frame models
    video_dims: int = 32              # FeatureExtractor output dim (2048 = bypass)

    mstcn_f_maps: int = 64
    mstcn_causal_conv: bool = True
    num_R: int = 3                    # COG refinement stages
    num_layers_R: int = 10
    num_layers_Basic: int = 11
    d_model: int = 64
    d_q: int = 8
    sequence_length: int = 30         # len_q: local attention window
    use_all_gestures: bool = True
    use_skill_prompt: bool = False
    SRM: bool = False                 # skill-reasoning module
    smooth_lambda: float = 0.15       # COG truncated-MSE smoothing weight

    fused_epoch: bool = True          # frame folds: every trial padded to one
                                      # common bucket (the per-trial loop runs)
    trial_batch: int = 1              # frame families: trials per step
    max_frames: int = 4096            # frame-model padding bucket ceiling

    def __post_init__(self):
        if self.model_name not in MODEL_NAMES:
            raise ValueError(f"unknown model_name {self.model_name!r}; one of {MODEL_NAMES}")
        if self.data_type not in ("multimodal", "video", "kinematics"):
            raise ValueError(f"unknown data_type {self.data_type!r}")
        if self.dataset_type not in ("window", "frame"):
            raise ValueError(f"unknown dataset_type {self.dataset_type!r}")
        if self.error_type not in ERROR_TYPE_TO_COLUMN and self.error_type != "sequential":
            raise ValueError(f"unknown error_type {self.error_type!r}")
        if self.pos_weight:
            raise NotImplementedError(
                "pos_weight (class-count loss weights) is not ported yet: "
                "ROADMAP.md Queue A5 (COG driver)")
        if self.trial_batch > 1:
            raise NotImplementedError(
                "trial_batch > 1 is not ported yet: ROADMAP.md Queue A6 "
                "(other frame families)")

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def in_features(self) -> int:
        """Model input width per data_type (reference ``in_features_dict``)."""
        video = self.video_dims
        return {"multimodal": video + 26, "video": video, "kinematics": 26}[self.data_type]

    def uses_feature_extractor(self) -> bool:
        """The 2048->video_dims MLP is used unless kinematics-only or raw
        2048-d features are fed directly (reference modeling_utils.py:58-75)."""
        return self.data_type != "kinematics" and self.video_dims != 2048
