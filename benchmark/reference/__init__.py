"""The plain reference that decides ``correct``: the configurations' models
from their equations in plain PyTorch (float32, TF32 off), with the products'
operand precision lowered only for the controls (``precision.Ops``).

It imports neither JAX nor anything of ``edge_diffusion_tts_tpu`` or
``edge_diffusion_tts_tpu_torch``, and takes only what the benchmark hands
both sides: the seeded weights (named as the upstream state dicts), tokens,
wavs, start noise, timesteps and the generator's seed.
"""
