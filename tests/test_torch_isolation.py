"""The port stands alone: med_tpu_torch, chip_smoke.py and trunk_gain.py
import neither JAX nor anything of the JAX package med_tpu. The import check
runs in a fresh interpreter, since this test process (conftest.py) has
imported JAX."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "med_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "med_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import med_tpu_torch
names = [m.name for m in pkgutil.walk_packages(med_tpu_torch.__path__, "med_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import trunk_gain
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "med_tpu")]
print(json.dumps({"modules": names, "forbidden": loaded}))
"""


def test_port_imports_no_jax_and_no_med_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("eval.serving", "utils.jax_params", "train.loop", "train.losses",
                 "train.optim", "ops.metrics", "data.preprocessing", "models.resnet",
                 "ops.resnet_fused", "cli.common", "cli.train_frame", "tracking",
                 "data.trials", "data.windowing", "eval.summary", "eval.rollup",
                 "utils.torch_port", "models.window_models", "data.siamese",
                 "cli.train_window", "cli.train_window_es",
                 "cli.train_window_es_sequential", "viz.utils", "eval.ensemble",
                 "eval.results", "ops.quant", "cli.ensemble", "cli.results",
                 "data.consensus", "data.augment", "cli.preprocess", "cli.resnet_finetune",
                 "models.clip_tokenizer", "models.clip_text", "models.prompts"):
        assert f"med_tpu_torch.{name}" in report["modules"]
    assert report["forbidden"] == []


def test_port_sources_name_no_jax_or_med_tpu_import():
    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "trunk_gain.py"]
    assert len(sources) > 10
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
