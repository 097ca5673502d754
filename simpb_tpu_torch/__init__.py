"""PyTorch + CUDA port of simpb_tpu for one NVIDIA H100.

Streaming 6-camera 2D+3D detection with temporal instance memory. The
package mirrors the layout of `simpb_tpu/` (configs, core, ops, models,
training, utils) so each module's counterpart is found by name. It
imports torch and numpy only, never JAX or the JAX package.
"""
