"""PyTorch/CUDA port of the HiFT system (``repro``), slice by slice.

The JAX package ``repro`` is the reference; this package keeps its names,
param-dict layout and tensor layouts, imports ``torch`` and nothing of
``repro`` or ``jax``, and runs its attention through hand-written CUDA
kernels (``repro_torch.kernels``) on the card.  Ported so far: the dense
family's serving path (prefill, contiguous decode, paged decode, both
engines and the serving launcher).
"""
