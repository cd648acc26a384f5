"""Hand-written Hopper kernels of the port, one package each: the CUDA
source under ``csrc/``, its build, its wrapper (``ops``) and its plain
PyTorch version (``ref``)."""
