"""Hand-written CUDA kernels of the device tier, their plain PyTorch versions
and the dispatch point (``ops``)."""
