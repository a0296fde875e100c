"""Visual odometry framework in JAX (stereo + monocular, batched XLA programs).

Accuracy contract: all f32 matmuls/einsums run at float32 precision.

On an NVIDIA GPU, JAX's default matmul precision lets f32 products run in
TF32 on the tensor cores, which keeps about three decimal digits. That is
fine for neural nets and fatal for geometry: this framework moves landmark
positions and keyframe pose matrices through one-hot einsum scatters
(mapping/arena.py, models/{stereo,mono}_vo.py keyframe-ring permutation),
so under the default every pose/point would be re-rounded each frame. The
pin below disables TF32 for every f32 matmul; the one-hot contractions it
covers are small.
"""

import jax as _jax

_jax.config.update("jax_default_matmul_precision", "float32")
