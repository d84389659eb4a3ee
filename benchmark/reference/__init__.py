"""Plain references: plain PyTorch in float32 (TF32 off) unless a function
takes another type, written from the published descriptions and the
reference repository's semantics. They import torch and numpy only:
neither JAX, nor the JAX package, nor anything of the port."""
