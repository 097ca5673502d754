"""PyTorch + CUDA port of simpb_tpu for one NVIDIA H100.

Streaming 6-camera 2D+3D detection with temporal instance memory. The
package mirrors the layout of `simpb_tpu/` (configs, core, data, ops,
models, training, utils, tools, and `bench`) so each module's
counterpart is found by name. It imports torch and numpy, never JAX or
the JAX package; scipy (the tracking scorer's assignment) and Pillow
(image decode) only inside the functions that need them.
"""
