"""PyTorch/CUDA port of the kubegpu_tpu serving stack.

A package of its own beside ``kubegpu_tpu``: it imports ``torch`` and
``numpy`` only — never ``jax``, ``flax`` or any module of the JAX
package — and keeps its own copies of what it needs from there.  Every
Pallas kernel of the ported path is a hand-written Hopper kernel
(``ops/csrc``), built from source at first use; plain PyTorch runs only
around the kernels and, for tensors on the CPU, in their place.

Layouts follow the JAX package at every public function (pools
``(P, h, page, hd)``, queries ``(b, h, hd)``, dense kernels
``(in, out)``), so the parity tests compare like with like.
"""
