"""PyTorch/CUDA port of bflc_demo_tpu — committee-consensus federated
learning on an NVIDIA H100.

The package mirrors `bflc_demo_tpu`'s module names so every port module
has an obvious counterpart in the JAX reference.  It imports `torch`,
never `jax`, and nothing of `bflc_demo_tpu`: what it needs of the
reference's jax-free modules (ledger, protocol constants, data) it keeps
as its own copies, each naming the file it copies.

Ported so far: the in-process committee round (`--runtime host`) of the
config-5 transformer preset, and the sequence-parallel long-context
transformer with ring attention (`parallel/`, `eval/long_context.py`),
with hand-written CUDA flash-attention kernels for both
(`ops/csrc/flash_attention.cu`).  Entry points run on `cuda` unless the
caller asks for the CPU (`device="cpu"`).
"""
