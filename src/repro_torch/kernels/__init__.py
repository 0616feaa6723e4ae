"""Hand-written CUDA kernels of the round and their plain PyTorch versions.

``ops`` routes on the device of the input; ``build`` compiles ``csrc/*.cu``
at the first launch.  Importing this package compiles and loads nothing.
"""
