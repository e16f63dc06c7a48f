"""sosvo: single-camera omnistereo visual odometry in JAX, on a GPU.

A from-scratch JAX/XLA framework with the capabilities of
`ubuntuslave/vo_single_camera_sos` (blueprint: SURVEY.md; contract:
BASELINE.json:5). Not a port: the compute path is pure functional JAX over
fixed-shape pytrees, and scaling is jax.sharding meshes with XLA collectives
(NCCL across the cards of a host).
"""

import jax as _jax

# Geometry correctness requires true-f32 matmuls: on the GPU, XLA may run an
# f32 matmul in TF32 (a 10-bit mantissa, about three decimal digits), which
# is catastrophic for pose math (3x3 chains, SVDs, normal equations). Hot
# kernels that *want* low precision (the Hamming-match bf16 matmul) request
# it explicitly with preferred_element_type/precision, so this global
# default only affects the f32 geometry path.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
