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
Diffusion SDEdit and inpainting path (``sige_torch.runners.SDRunner``),
the PD and GauGAN editing paths, and the interactive editing path: the
demo runners with per-step cache slots (``sige_torch.demo``), the
multi-session ``sige_torch.parallel.SessionServer`` and the HTTP demo
(``python -m sige_torch.demo.server``). Reference checkpoints reach it
through its own converters (``sige_torch.utils.convert``,
``convert_sd``) and native checkpoints (``utils.checkpoint``), and the
suites' command lines are ``python -m sige_torch.cli.diffusion``,
``cli.gaugan`` and ``cli.sd``.
"""

__version__ = "0.1.0"
