"""PyTorch/CUDA port of the HiFT system (``repro``), slice by slice.

The JAX package ``repro`` is the reference; this package keeps its names,
param-dict layout and tensor layouts, imports ``torch`` and nothing of
``repro`` or ``jax``, and runs its kernels as hand-written CUDA
(``repro_torch.kernels``) on the card.  Ported so far: the dense family's
serving path (prefill, contiguous and paged decode, both engines and the
serving launcher), its training path (all eight strategies of the
reference with AdamW, SGD-momentum, SGD, AdaGrad and Adafactor, the
precision policies, the synthetic data, the loop, checkpoints and the
training launcher), quantized resident state (``QuantConfig``: int8/NF4
codecs in ``dist.quant``, the dequant-matmul kernel, bf16 moments), and
the hybrid family (zamba2: ``models.mamba2``, ``models.zamba2``) for
serving, through the SSM scan kernel, and for training with every
strategy, through the plain chunked scan.
"""
