"""PyTorch + CUDA port of the m3f valence-arousal system for an NVIDIA H100.

The JAX package ``m3f.pytorch_tpu`` is the reference; this package mirrors
its layout (``config``, ``nn``, ``ops``, ``models``, ``train``, ``infer``) so
each module has a counterpart there, and imports nothing from it.

- Activations stay channels-last (NDHWC / NHWC) at every module boundary,
  compute is bf16 with fp32 parameters, as in the reference.
- The three Pallas kernel families of the reference are hand-written CUDA
  kernels for ``sm_90a`` (``csrc/*.cu``), built on first use with ``nvcc``
  into ``build/kernels/`` and bound with ``ctypes`` (``ops/cuda_lib.py``).
- Every kernel wrapper runs its plain PyTorch version only for tensors on
  the CPU (the tests); for a CUDA tensor it launches the kernel or raises.
- Entry points (``infer.predictor.Predictor``, ``train.loop.Trainer``,
  ``models.m3f.M3F``) default to ``device="cuda"`` and raise when no GPU is
  present.
"""

__version__ = "0.1.0"
