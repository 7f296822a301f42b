"""vision_basedsensor_tpu_torch — the marker-to-pose path in PyTorch + CUDA.

A port of ``vision_basedsensor_tpu`` (JAX/XLA/Pallas for the TPU) to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper. The JAX package stays the
reference; every module here names its JAX counterpart, mirrors its module
path and function names (``ops/pallas/`` becomes ``ops/cuda/``), and is
tested against it on the same inputs (``tests/test_torch_*.py``).

The package imports torch and numpy only: never jax, and never
``vision_basedsensor_tpu`` (whose ``__init__`` loads jax). ``config.py`` and
``layout.py`` are therefore copies; ``convert.py`` carries JAX-side state
across as numpy arrays and JSON.

Functions are eager and batched: ``jit`` disappears, ``vmap`` becomes a
written-out leading batch axis, ``lax.scan``/``fori_loop`` become Python
loops. The device is taken from the input tensors.
"""
import torch

# The reference runs its filter and moment matmuls at Precision.HIGHEST
# (vision_basedsensor_tpu/ops/moments.py:387). The banded-matmul blurs are
# then rounded to integers (core/imaging.py:137-139) and reduced mod 256
# (ops/dog.py:30-32), so TF32's 10-bit mantissa would flip DoG mask pixels.
# Keep every float32 matmul and convolution in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

__all__ = ["initialize", "process_frames", "run_video", "__version__"]


def __getattr__(name):  # lazy, like the JAX package's top level
    if name in ("initialize", "process_frames", "run_video"):
        from vision_basedsensor_tpu_torch import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)
