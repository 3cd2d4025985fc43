"""The benchmark harness of the PyTorch/CUDA port: the manifest, the
device readings, the kinds of traffic, the trace reduction and the
correctness checks. Nothing here imports JAX or the JAX package; the port
is imported only by the traffic kinds, inside their functions."""
