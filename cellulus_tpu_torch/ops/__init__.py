"""Device operations of the port: the hand-written kernels' wrappers and
the plain PyTorch and host code around them."""
