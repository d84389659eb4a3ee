"""How far the seeded ResNet-50 trunk of ``chip_smoke.py`` amplifies
rounding, with each block's last BN (bn3) at full scale and at the smoke's
``RESIDUAL_SCALE``, on the CPU (no GPU needed):

    python3 trunk_gain.py             # 8 frames, as the smoke's fp32 checks
    python3 trunk_gain.py --batch 4

For each bn3 scale it builds the smoke's full-width trunk from the same seed
(BN statistics measured on the CPU) and prints, on the smoke's first
``--batch`` seeded 224x224 frames, relative L2 errors of the pooled
features:

- gain: the fp32 trunk's change for a 1e-6 relative change of its input;
- fp32 ``resnet50_fused_apply`` (its stages through the plain version of
  the stage kernel on the CPU) against fp32 ``ResNet50``: both fp32, they
  differ by rounding only;
- bf16 ``ResNet50`` and bf16 ``resnet50_fused_apply``, each against fp32
  ``ResNet50``, and the two against each other.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

import chip_smoke as smoke
from med_tpu_torch.eval.serving import PixelFrontEnd
from med_tpu_torch.ops.resnet_fused import fold_trunk, resnet50_fused_apply
from med_tpu_torch.train.checkpoint import load_checkpoint


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


@torch.no_grad()
def measure(scale: float, batch: int) -> dict:
    geometry = dict(stage_sizes=smoke.TRUNK["stage_sizes"], width=smoke.TRUNK["width"],
                    device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path, _, _ = smoke._seeded_trunk(tmp, device="cpu", residual_scale=scale)
        fp32 = PixelFrontEnd.from_checkpoint(path, dtype=torch.float32, **geometry)
        bf16 = PixelFrontEnd.from_checkpoint(path, dtype=torch.bfloat16, **geometry)
        ckpt = load_checkpoint(path)
    tree = {"params": ckpt["params"]["trunk"], "batch_stats": ckpt["batch_stats"]["trunk"]}
    # phase 6's frames: the first `batch` of its 128-frame batch
    rng = np.random.default_rng(smoke.SEED + 1)
    side = smoke.TRUNK["frame"]
    frames = rng.integers(0, 256, (smoke.TRUNK_BATCH, side, side, 3), np.uint8)[:batch]
    x = (torch.from_numpy(frames).float() / 255.0 - fp32.mean) / fp32.std
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(smoke.SEED))
    apply = dict(stage_sizes=smoke.TRUNK["stage_sizes"])

    exact = fp32.net(x)
    moved = fp32.net(x + 1e-6 * torch.linalg.norm(x) / torch.linalg.norm(noise) * noise)
    fused32 = resnet50_fused_apply(fold_trunk(tree, dtype=torch.float32), x,
                                   dtype=torch.float32, **apply)
    module16 = bf16.net(x)
    fused16 = resnet50_fused_apply(fold_trunk(tree, dtype=torch.bfloat16), x,
                                   dtype=torch.bfloat16, **apply)
    return {"gain": rel(moved, exact) / 1e-6,
            "fp32 fused vs module": rel(fused32, exact),
            "bf16 module vs fp32": rel(module16, exact),
            "bf16 fused vs fp32": rel(fused16, exact),
            "bf16 fused vs module": rel(fused16, module16)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=smoke.FP32_BATCH)
    args = ap.parse_args()
    torch.manual_seed(smoke.SEED)
    print(f"torch {torch.__version__}, CPU, {torch.get_num_threads()} threads; "
          f"ResNet-50 {smoke.TRUNK['stage_sizes']} width {smoke.TRUNK['width']}, "
          f"{args.batch} frames of {smoke.TRUNK['frame']}x{smoke.TRUNK['frame']}")
    for scale in (1.0, smoke.RESIDUAL_SCALE):
        r = measure(scale, args.batch)
        print(f"bn3 scale {scale}: " + ", ".join(f"{k} {v:.4g}" for k, v in r.items()),
              flush=True)


if __name__ == "__main__":
    main()
