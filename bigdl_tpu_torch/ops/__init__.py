"""bigdl_tpu_torch.ops — hand-written Hopper kernels for the hot ops.

K1 flash-attention forward (CUDA C++, ``csrc/flash_fwd.cu``) with its
backward K2 dK/dV and K3 dQ (``csrc/flash_bwd.cu``) in
``ops.flash_attention``, and K4 LayerNorm forward (Triton) in
``ops.layer_norm``; the fused softmax cross entropy
(``ops.fused_xent``) is plain PyTorch, as its JAX counterpart is jnp.
Each wrapper runs its plain PyTorch version for CPU tensors only; a
CUDA tensor launches the kernel or raises, forward and backward.  The
package re-exports no function, so ``ops.flash_attention`` stays the
module (with its launch counters), not the function of that name.
"""
