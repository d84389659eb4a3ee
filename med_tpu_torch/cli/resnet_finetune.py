"""Per-fold ResNet-50 fine-tuning on raw frames + feature export (port of
``med_tpu.cli.resnet_finetune``, the same flags, printed lines and files,
plus ``--device``; reference notebooks/resnet_finetuning.ipynb + the
create_pkl_files feature path, preprocessing_utils.py:722-823):

    python -m med_tpu_torch.cli.resnet_finetune --data-root <raw-frame folds> \\
        --output-root <feature folds>

Input: fold dirs whose trial files carry raw frames — ``image_feats`` of
shape (N, H, W, 3) uint8 (or float 0..255). Per fold: train trunk + fc
2048->512->1 with BCE on the binary error label (batch 32, 5 epochs, lr 5e-4
— reference cell 6), keep the best-test-accuracy checkpoint
(``resnet50_<fold>.npz`` in ``med_tpu``'s tree, which both packages'
``PixelFrontEnd.from_checkpoint`` read), then swap the head for the trunk
output and export (N, 2048) features as ``<out>/<fold>/<trial>.npz`` trials
consumable by every other driver.

Pixel path: /255 + per-fold channel mean/std normalization, on the device,
after the augmentation (:mod:`med_tpu_torch.data.augment`, its draws from a
generator seeded by ``--seed``) unless ``--no-augment``. It trains on the
GPU and raises without one; ``--device cpu`` runs on the CPU. fp32
throughout: the command switches TF32 off for matmuls and cuDNN, and picks
cuDNN's deterministic algorithms.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.augment import augment_batch, draw_augment
from ..data.trials import Trial, fold_file_list, load_trial, save_trial_npz
from ..models import init_weights
from ..models.resnet import ResNetClassifier, load_pretrained_trunk
from ..ops.metrics import confusion_matrix, metrics_from_cm
from ..ops.quant import quantize_resnet50_trunk, resnet50_int8_apply, tree_to
from ..tracking import RunTracker
from ..train.checkpoint import save_checkpoint
from ..train.losses import bce_with_logits
from ..utils.device import resolve_device
from ..utils.jax_params import export_jax_params, load_jax_params
from .common import _refuse_multi_gpu


def _batches(images, labels, batch_size, shuffle, seed):
    """Batches of ``batch_size`` in ``default_rng(seed)``'s shuffled order;
    the last is padded with image 0 of the whole array, masked 0."""
    n = len(images)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for s in range(0, n, batch_size):
        take = idx[s : s + batch_size]
        pad = batch_size - len(take)
        sel = np.concatenate([take, np.zeros(pad, np.int64)]) if pad else take
        mask = np.concatenate([np.ones(len(take), np.float32),
                               np.zeros(pad, np.float32)])
        yield images[sel], labels[sel], mask


def preprocess(x: torch.Tensor, pixel_stats) -> torch.Tensor:
    """Raw 0..255 pixels -> /255, standardized by the fold's channel stats."""
    mean, std = pixel_stats
    return (x.to(torch.float32) / 255.0 - mean) / std


def train_step(model: ResNetClassifier, optimizer: torch.optim.Optimizer, imgs, labels,
               mask, pixel_stats, freeze_bn: bool = False, draws=None) -> torch.Tensor:
    """One fine-tune step on the model's device: augment (with ``draws``) or
    preprocess, the classifier with train-mode BatchNorm (running
    statistics with ``freeze_bn``, every parameter still trained), masked
    BCE, Adam. Returns the loss; the gradients stay in ``.grad``."""
    dev = pixel_stats[0].device
    x = torch.as_tensor(imgs).to(dev, torch.float32)
    if draws is not None:
        pix = augment_batch(x, draws, normalize=pixel_stats)
    else:
        pix = preprocess(x, pixel_stats)
    logits = model(pix, train=not freeze_bn)
    loss = bce_with_logits(logits, torch.as_tensor(labels).to(dev),
                           torch.as_tensor(mask).to(dev))
    optimizer.zero_grad(set_to_none=False)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def eval_cm(model: ResNetClassifier, imgs, labels, mask, pixel_stats) -> torch.Tensor:
    """The (2, 2) confusion matrix of a batch's thresholded predictions,
    padded rows masked out."""
    dev = pixel_stats[0].device
    logits = model(preprocess(torch.as_tensor(imgs).to(dev), pixel_stats), train=False)
    preds = (torch.sigmoid(logits.reshape(-1)) > 0.5).to(torch.int32)
    return confusion_matrix(torch.as_tensor(labels).to(dev), preds, 2,
                            torch.as_tensor(mask).to(dev))


def finetune_fold(fold_dir, args, tracker, fold_name):
    device = resolve_device(args.device)

    def load_split(csv):
        imgs, labels, trials = [], [], []
        for fname in fold_file_list(fold_dir, csv):
            t = load_trial(os.path.join(fold_dir, fname))
            if t.image_feats.ndim != 4:
                raise SystemExit(
                    f"{fname}: expected raw frames (N,H,W,3); got "
                    f"{t.image_feats.shape} — this driver needs raw-frame folds"
                )
            imgs.append(t.image_feats)
            labels.append(t.e_labels[:, 4])
            trials.append(t)
        return np.concatenate(imgs), np.concatenate(labels), trials

    train_imgs, train_labels, train_trials = load_split("train.csv")
    test_imgs, test_labels, test_trials = load_split("test.csv")
    mean = (train_imgs.reshape(-1, 3).mean(0) / 255.0).astype(np.float32)
    std = (train_imgs.reshape(-1, 3).std(0) / 255.0 + 1e-6).astype(np.float32)
    pixel_stats = (torch.from_numpy(mean).to(device), torch.from_numpy(std).to(device))

    model = init_weights(ResNetClassifier(bn_stat_stride=args.bn_stat_stride),
                         torch.Generator().manual_seed(args.seed))
    if args.init_weights:
        # pretrained trunk start (reference resnet_finetuning.ipynb cell 7:
        # resnet50(pretrained=True)); the fc head stays freshly initialized,
        # exactly like the reference's replaced head
        model.trunk.load_state_dict(load_pretrained_trunk(args.init_weights), strict=True)
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    aug = torch.Generator().manual_seed(args.seed)

    best_acc, best = -1.0, None
    for epoch in range(args.n_epochs):
        t0 = time.time()
        for imgs, labels, mask in _batches(train_imgs, train_labels,
                                           args.batch_size, True,
                                           args.seed + epoch):
            draws = draw_augment(len(imgs), aug) if args.augment else None
            loss = train_step(model, optimizer, imgs, labels, mask, pixel_stats,
                              args.freeze_bn, draws)
        cm = torch.zeros((2, 2), dtype=torch.int64, device=device)
        for imgs, labels, mask in _batches(test_imgs, test_labels,
                                           args.batch_size, False, 0):
            cm += eval_cm(model, imgs, labels, mask, pixel_stats)
        acc = metrics_from_cm(cm.cpu().numpy(), "binary")["accuracy"]
        tracker.log_metrics({f"{fold_name}_loss": float(loss),
                             f"{fold_name}_test_acc": acc}, step=epoch)
        print(f"[{fold_name}] epoch {epoch} acc={acc:.3f} "
              f"({time.time() - t0:.1f}s)")
        if acc > best_acc:
            best_acc = acc
            best = export_jax_params(model)

    save_checkpoint(tracker.checkpoint_path(f"resnet50_{fold_name}.npz"),
                    best["params"], best["batch_stats"],
                    meta={"mean": mean.tolist(), "std": std.tolist(),
                          "best_acc": best_acc})

    # feature export: head -> identity (the trunk's output), or with
    # --int8-trunk the int8 PTQ serving trunk (ops/quant.py, calibrated on
    # the CPU on the first 32 train frames)
    if args.int8_trunk:
        calib = preprocess(torch.from_numpy(train_imgs[: min(32, len(train_imgs))]),
                           (torch.from_numpy(mean), torch.from_numpy(std)))
        qt = tree_to(quantize_resnet50_trunk(
            {"params": best["params"]["trunk"], "batch_stats": best["batch_stats"]["trunk"]},
            calib.numpy()), device)

        def features(x):
            return resnet50_int8_apply(qt, preprocess(x, pixel_stats))
    else:
        state, _ = load_jax_params(best, model)
        model.load_state_dict(state, strict=True)

        def features(x):
            return model.features(preprocess(x, pixel_stats), train=False)

    out_dir = os.path.join(args.output_root, fold_name)
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        for trial in train_trials + test_trials:
            feats = [features(torch.from_numpy(trial.image_feats[s : s + args.batch_size])
                              .to(device)).cpu().numpy()
                     for s in range(0, trial.n_frames, args.batch_size)]
            save_trial_npz(
                os.path.join(out_dir, trial.name + ".npz"),
                Trial(trial.name, np.concatenate(feats), trial.kinematics,
                      trial.g_labels, trial.e_labels, trial.frames),
            )
    for csv in ("train.csv", "test.csv"):
        with open(os.path.join(fold_dir, csv)) as f_in, open(
            os.path.join(out_dir, csv), "w"
        ) as f_out:
            f_out.write(f_in.read())
    return best_acc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", required=True, help="raw-frame fold dirs")
    p.add_argument("--output-root", required=True, help="feature fold output")
    p.add_argument("--folds", default="1Out,2Out,3Out,4Out,5Out")
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--n-epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--augment", action="store_true", default=True)
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.add_argument("--device", default=None,
                   help="torch device to train on. Default: CUDA, which must "
                        "be there; 'cpu' runs on the CPU")
    p.add_argument("--mesh", default=None,
                   help="multi-GPU data-parallel fine-tuning (not ported yet)")
    p.add_argument("--int8-trunk", action="store_true", default=False,
                   help="export features through the int8 PTQ serving "
                        "trunk (ops/quant.py). Serving-only knob")
    p.add_argument("--bn-stat-stride", type=int, default=1,
                   help="ghost-batch BN: train-mode statistics from the "
                        "first batch/N images (models/resnet.py::BatchNorm). "
                        "1 = exact BatchNorm (reference parity, default)")
    p.add_argument("--freeze-bn", action="store_true", default=False,
                   help="BatchNorm uses running statistics during training "
                        "(torch trunk.eval() idiom); all params still "
                        "train. Deviates from the reference's train-mode "
                        "BN — a perf knob, not the parity default")
    p.add_argument("--init-weights", default=None,
                   help="torchvision-format resnet50 weights (.pth/.pt/.npz) "
                        "to start the trunk from (the reference starts from "
                        "ImageNet pretrained weights)")
    args = p.parse_args(argv)
    _refuse_multi_gpu(args)
    resolve_device(args.device)
    # fp32 as in the JAX package: no TF32 in matmuls or cuDNN (no Experiment
    # is made here to switch it off), and cuDNN's deterministic algorithms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    tracker = RunTracker(root=args.runs_root, experiment="ResNet50_finetune")
    tracker.log_params(vars(args))
    for fold in args.folds.split(","):
        acc = finetune_fold(os.path.join(args.data_root, fold), args, tracker,
                            fold)
        print(f"fold {fold}: best acc {acc:.3f}")


if __name__ == "__main__":
    main()
