"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the tile dispatch that shapes them."""
