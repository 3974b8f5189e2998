"""superconductor_vae_tpu_torch — the PyTorch/CUDA port of superconductor_vae_tpu.

The JAX package beside it stays the reference; every sub-package here is
named after its counterpart there, so ``models/decoder.py`` ports
``superconductor_vae_tpu/models/decoder.py``.  The port imports ``torch``
and nothing of JAX or of the JAX package; it keeps its own copies of the
host-side modules it needs (``chem``, ``tokenizer``).

Kernels written by hand for Hopper live in ``csrc/`` and are built with
``nvcc`` on first use (``ops/_build.py``).  Each has a plain PyTorch
version beside its wrapper, which is what runs for tensors on the CPU.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; pass ``device="cpu"`` explicitly to run the plain paths.
"""

__version__ = "0.1.0"
