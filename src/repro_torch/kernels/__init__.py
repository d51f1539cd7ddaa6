"""The port's kernels: each TPU kernel of `repro.kernels` becomes a
hand-written Hopper kernel (`csrc/`), built by `_build`, beside a plain
PyTorch version of the same function that CPU tensors run."""
