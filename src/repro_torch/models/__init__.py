"""Decode-side model code of the dense family (the JAX package's ``models``)."""
