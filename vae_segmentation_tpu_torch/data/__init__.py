"""Manifest, case loading (the native loader of ``csrc/fastloader.cpp``
and its numpy path), resize, the host transform library, offline
preprocessing, synthetic phantoms and the eval / train batch pipeline
(copies of the JAX package's host modules)."""
