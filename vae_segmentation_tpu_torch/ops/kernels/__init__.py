"""CUDA C++ sources (``csrc/``) of the port's kernels and ``build.py``,
which compiles and loads them."""
