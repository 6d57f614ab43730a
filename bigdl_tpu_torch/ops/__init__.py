"""bigdl_tpu_torch.ops — hand-written Hopper kernels for the hot ops.

K1 flash-attention forward (CUDA C++, ``csrc/flash_fwd.cu``) in
``ops.flash_attention`` and K4 LayerNorm forward (Triton) in
``ops.layer_norm``.  Each wrapper runs its plain PyTorch version for
CPU tensors only; a CUDA tensor launches the kernel or raises.  The
package re-exports no function, so ``ops.flash_attention`` stays the
module (with its ``LAUNCHES`` counter), not the function of that name.
"""
