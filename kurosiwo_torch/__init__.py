"""PyTorch/CUDA port of kurosiwo_tpu for NVIDIA Hopper (H100).

The JAX package ``kurosiwo_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
