"""PyTorch/CUDA port of ``distributed_tensorflow_tpu``.

Grows beside the JAX package, slice by slice, under the same module paths
and public names; the JAX package stays the reference the port is tested
against. This package imports torch and numpy, never JAX, flax, optax,
orbax or the JAX package itself.

Entry points run on the CUDA card by default and raise when there is none;
the CPU is used only when a caller passes ``device="cpu"``.
"""
