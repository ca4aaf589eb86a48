"""Device ops: the hand-written CUDA kernels and the bit packer around them."""
