"""Faults planted in the program underneath a run, to see ``correct`` come
out false: a step that returns its state unchanged, half of the batch left
out with the mean over the rest, an answer altered where it is produced.
Used by ``tests/test_perfbench_faults.py`` (tiny sizes, on the CPU) and by
``tools/readings.py --fault`` (the cell's own size, on the card)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = {"cog.train": ("unchanged", "half", "altered"),
          "resnet50.finetune": ("unchanged", "half", "altered"),
          "cog.pixels": ("altered", "features")}


def _swap(patches, owner, name, value):
    patches.append((owner, name, getattr(owner, name)))
    setattr(owner, name, value)


@contextlib.contextmanager
def planted(cell: str, fault: str):
    if fault not in FAULTS.get(cell, ()):
        raise ValueError(f"{cell} has no fault {fault!r}; it has {FAULTS.get(cell)}")
    patches = []
    try:
        if fault == "unchanged":
            _swap(patches, torch.optim.Adam, "step", lambda self, closure=None: None)
        elif cell == "cog.train" and fault == "half":
            from med_tpu_torch.train import engine

            original = engine.Experiment._tensors

            def half_trial(self, batch):
                data = original(self, batch)
                data["true_len"] = data["true_len"] // 2
                return data

            _swap(patches, engine.Experiment, "_tensors", half_trial)
        elif cell == "cog.train":
            from med_tpu_torch.train import losses

            track = losses.cog_track_loss

            def altered_track(*args, **kwargs):
                ce, sm = track(*args, **kwargs)
                return ce * 1.01, sm

            _swap(patches, losses, "cog_track_loss", altered_track)
        elif cell == "resnet50.finetune":
            from med_tpu_torch.cli import resnet_finetune

            bce = resnet_finetune.bce_with_logits

            def half_batch(logits, labels, mask=None, pos_weight=None, group=None):
                kept = mask.clone()
                kept[len(kept) // 2:] = 0
                return bce(logits, labels, kept, pos_weight, group)

            _swap(patches, resnet_finetune, "bce_with_logits",
                  half_batch if fault == "half" else (lambda *a, **k: bce(*a, **k) * 1.01))
        elif fault == "altered":
            from med_tpu_torch.eval import serving

            predict = serving.FrameModelServer.predict_trial

            def altered_answer(self, images, kinematics):
                preds, probs = predict(self, images, kinematics)
                probs = probs.copy()
                probs[0] = probs[0] + 0.3 if probs[0] < 0.5 else probs[0] - 0.3
                return preds, probs

            _swap(patches, serving.FrameModelServer, "predict_trial", altered_answer)
        else:
            from med_tpu_torch.eval import serving

            features = serving.PixelFrontEnd.features
            _swap(patches, serving.PixelFrontEnd, "features",
                  lambda self, frames: features(self, frames) * np.float32(1.1))
        yield
    finally:
        for owner, name, value in reversed(patches):
            setattr(owner, name, value)
