"""PyTorch/CUDA port of bflc_demo_tpu — committee-consensus federated
learning on an NVIDIA H100.

The package mirrors `bflc_demo_tpu`'s module names so every port module
has an obvious counterpart in the JAX reference.  It imports `torch`,
never `jax`, and nothing of `bflc_demo_tpu`: what it needs of the
reference's jax-free modules (ledger, protocol constants, data) it keeps
as its own copies, each naming the file it copies.

This slice ports the in-process committee round (`--runtime host`) of the
config-5 transformer preset, with hand-written CUDA flash-attention
kernels (`ops/csrc/flash_attention.cu`).  Entry points run on `cuda`
unless the caller asks for the CPU (`device="cpu"`).
"""
