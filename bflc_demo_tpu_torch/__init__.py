"""PyTorch/CUDA port of bflc_demo_tpu — committee-consensus federated
learning on an NVIDIA H100.

The package mirrors `bflc_demo_tpu`'s module names so every port module
has an obvious counterpart in the JAX reference.  It imports `torch`,
never `jax`, and nothing of `bflc_demo_tpu`: what it needs of the
reference's jax-free modules (ledger, protocol constants, data) it keeps
as its own copies, each naming the file it copies.

Ported so far: configs 1 and 5 on the mesh runtime (the reference CLI's
default: one device round per protocol round, payload ids from a
hand-written CUDA fingerprint kernel, `ops/csrc/fingerprint.cu`) and on
the in-process host runtime, and the sequence-parallel long-context
transformer with ring attention (`parallel/`, `eval/long_context.py`),
with hand-written CUDA flash-attention kernels for all of them
(`ops/csrc/flash_attention.cu`).  Entry points run on `cuda` unless the
caller asks for the CPU (`device="cpu"`).
"""
