"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``<kernel>/ref.py`` is the plain version, ``<kernel>/ops.py`` the
wrapper that runs it for CPU tensors and launches the kernel (built from
``csrc/`` by ``kernels/build.py``) for CUDA tensors."""
