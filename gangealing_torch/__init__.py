"""gangealing_torch — the PyTorch and CUDA port of gangealing_tpu.

It serves the flagship ComposedSTN congeal forward, trains GANgealing
(``python -m gangealing_torch.cli.train``) and runs the AR object lenses
(``python -m gangealing_torch.cli.mixed_reality``) on an NVIDIA H100, or
over ranks, one a card (``torchrun``; ``parallel/``),
through CUDA kernels written by hand (``csrc/``): the mipmap and bilinear
samplers, forward and backward, the Gaussian splat, and the FIR resampler
(``upfirdn2d``), forward and backward. On CPU tensors
every op runs its plain PyTorch version, which the tests hold against the
JAX package; the port imports nothing of that package.

The layouts at the public functions are the JAX package's: images NCHW,
sampling grids (N, Ho, Wo, 2) with x then y, flows (N, H, W, 2).
"""

from gangealing_torch._build import LAUNCHES, load_kernels  # noqa: F401

__version__ = "0.1.0"
