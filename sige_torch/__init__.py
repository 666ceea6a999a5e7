"""sige_torch: the PyTorch/CUDA port of the Spatially Incremental
Generative Engine.

It runs beside ``sige_tpu`` (the JAX reference) and imports nothing of
it, nor JAX. Activations are NHWC at module boundaries, as in
``sige_tpu``. Entry points run on the GPU unless the caller passes
``device="cpu"``; the attention kernel is hand-written CUDA for Hopper
(``csrc/flash_attn.cu``), built with ``nvcc`` on first use.

It runs the DDPM church256 SDEdit path in the tile and window layouts
(``layout="auto"`` picks per edit) with the DDPM, DDIM and DPM-Solver
samplers (``sige_torch.runners.DiffusionRunner``), and the Stable
Diffusion SDEdit and inpainting path (``sige_torch.runners.SDRunner``).
"""

__version__ = "0.1.0"
