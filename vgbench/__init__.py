"""vgbench: the benchmark of vgtpu_torch, the PyTorch + CUDA port, on one
H100.  See README.md."""
