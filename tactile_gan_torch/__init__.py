"""PyTorch/CUDA port of tactile_gan_tpu for NVIDIA Hopper (H100).

The package mirrors ``tactile_gan_tpu``'s layout module for module. It imports
``torch`` and never JAX or the JAX package; framework-free helpers are kept as
local copies. Entry points run on ``device="cuda"`` unless the caller asks
for the CPU (see ``core/device.py``).
"""
