"""The benchmark of the PyTorch and CUDA port, ``spfx_torch``, on an NVIDIA
GPU. Run ``python -m portbench --help``; ``BENCHMARK.json`` names its
cells. It imports neither JAX nor the JAX package ``spfx``."""
