"""Manifest, host transforms, resize, synthetic phantoms and the eval
batch pipeline (numpy/scipy copies of the JAX package's host modules)."""
