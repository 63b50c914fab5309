"""PyTorch port of centerpoly_tpu for one NVIDIA H100.

The JAX package `centerpoly_tpu` is the reference; this package imports
torch and nothing of JAX or of that package.  Every DCNv2 node runs the
hand-written CUDA kernel of csrc/dcn_fwd.cu on the card.
"""
