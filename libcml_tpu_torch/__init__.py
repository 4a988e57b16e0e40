"""libcml_tpu_torch — the PyTorch/CUDA port of libcml_tpu for NVIDIA Hopper.

Same SLAM model, same numpy inputs, same outputs and the same state layout
(fixed-capacity arenas with validity masks) as the JAX package, written as
plain PyTorch functions on tensors with an explicit `device` everywhere.
The one hand-written TPU kernel of the JAX package (the fused masked-Hamming
match resolution) is a hand-written CUDA kernel here
(`ops/hamming_match.py`, `csrc/hamming_match.cu`), and so are the JAX
package's two device LM loops, the direct tracker's (`ops/track_lm.py`,
`csrc/track_lm.cu`) and motion-only PnP's (`ops/pnp_lm.py`,
`csrc/pnp_lm.cu`).

Device rule: entry points run on the CUDA card unless the caller passes
`device="cpu"`; without CUDA they raise instead of carrying on on the CPU
(`_device.resolve_device`).

Subpackages mirror the JAX package: core, ops, models (direct, indirect),
map, runtime, eval, data, utils.
"""

import torch as _torch

# SLAM numerics (pose composition, Hessian assembly, Schur solves) need true
# f32 matmuls: TF32 keeps ~3 decimal digits and silently corrupts small
# 3x3/6x6/8x8 products (mirrors libcml_tpu's float32 matmul precision).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
