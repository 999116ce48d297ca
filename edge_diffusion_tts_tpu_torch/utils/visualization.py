"""GT-vs-generated mel PNG grids (counterpart of
``edge_diffusion_tts_tpu/utils/visualization.py``).

``visualize_generation`` renders the ground-truth normalized mel above
N-step generations with each one's MSE, to
``<run_dir>/samples/gen_step_<step>.png``.  matplotlib is imported when the
function is called, never at import, and its absence raises a clear error.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def visualize_generation(
    generate_fn,
    gt_mel,
    step: int,
    run_dir: str,
    steps_list: Sequence[int] = (4, 8, 16),
) -> str:
    """Render GT vs few-step generations; returns the PNG path.

    ``generate_fn(num_steps) -> mel [T, n_mels]`` closes over the model, the
    conditioning and its own draws."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(
            "visualize_generation needs matplotlib, which is not installed; train with "
            "plot_every_steps=0 to turn the sample plots off") from e

    def host(a):
        return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)

    n = len(steps_list) + 1
    fig, axes = plt.subplots(n, 1, figsize=(10, 2.2 * n), constrained_layout=True)
    gt = host(gt_mel)
    axes[0].imshow(gt.T, origin="lower", aspect="auto", cmap="magma")
    axes[0].set_title("ground truth (normalized log-mel)")
    for ax, num_steps in zip(axes[1:], steps_list):
        gen = host(generate_fn(num_steps))
        T = min(gen.shape[0], gt.shape[0])
        mse = float(np.mean((gen[:T] - gt[:T]) ** 2))
        ax.imshow(gen.T, origin="lower", aspect="auto", cmap="magma")
        ax.set_title(f"{num_steps}-step generation  (MSE {mse:.4f})")
    out_dir = os.path.join(run_dir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"gen_step_{step}.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
