"""What a run refuses to do: print a result without the cards its cell asks
for, or with the JAX package, JAX or flax loaded in its process."""

from __future__ import annotations

import sys
from typing import Iterable, List

# compared whole against each module's top-level name (the part before the
# first dot): med_tpu_torch is another name than med_tpu
FORBIDDEN = ("jax", "jaxlib", "flax", "med_tpu")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names in ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_no_jax() -> None:
    """Exit with code 3, naming what was found, when the process holds a
    forbidden module."""
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"refused: the process loaded {', '.join(found[:20])} "
              f"(forbidden top-level names: {', '.join(FORBIDDEN)})", file=sys.stderr)
        raise SystemExit(3)


def check_cards(chips: int) -> None:
    """Exit with code 2 unless CUDA is there with at least ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        print("refused: torch.cuda.is_available() is false; the benchmark runs "
              "only on an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(2)
    have = torch.cuda.device_count()
    if have < chips:
        print(f"refused: the cell needs {chips} cards, torch sees {have}",
              file=sys.stderr)
        raise SystemExit(2)
