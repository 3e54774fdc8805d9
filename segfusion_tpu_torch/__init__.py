"""PyTorch/CUDA port of SegFusion's online joint inference stream, its
evaluation and its online training.

Counterpart of ``segfusion_tpu`` (the JAX reference) for one NVIDIA H100:
the same module layout (``ops/``, ``models/``, ``core/``, ``data/``,
``utils/``), the same public array layouts (NHWC net inputs, (rows, 128)
slot tensors), and hand-written CUDA kernels for the Pallas shadow and
reconcile kernels (``ops/kernels/shadow_build.py``,
``csrc/shadow_build.cu``). Imports torch and never jax.
"""
