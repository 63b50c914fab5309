"""The plain reference of the benchmark's cells: plain PyTorch and numpy,
frozen copies of the two networks (DLA-34 with its DCNv2 nodes, the
small hourglass; found by arch name under archs/), the plain deformable convolution with its y-clamp, the
input warp, the polydet decode and post-process, the v2 training loss and
Adam.  It imports nothing of the port and nothing of JAX; it is given the
weights and inputs that the benchmark made."""
