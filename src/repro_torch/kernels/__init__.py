"""Hand-written CUDA kernels (FedNL's round, the LM zoo's attention) and
their plain PyTorch versions.

``ops`` routes on the device of the input; ``build`` compiles ``csrc/*.cu``
at the first launch.  Importing this package compiles and loads nothing.
"""
