"""Training-history plots.

Port of ``celebrity_image_denoiser_tpu/viz/training_plots.py::plot_metrics:21``
(the reference's ``training.py:181-227``): one 2×3 summary figure (G/D
loss, PSNR, SSIM, LPIPS, MS-SSIM) plus one PNG per metric, written into a
graphs directory.  matplotlib is imported on use: where it is missing,
``plot_metrics`` raises its ``ImportError`` before it writes anything.
"""

from __future__ import annotations

import os
from typing import Dict, List

from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.viz")

_METRICS = ["g_loss", "d_loss", "psnr", "ssim", "lpips", "msssim"]
_TITLES = ["Generator Loss", "Discriminator Loss", "PSNR", "SSIM", "LPIPS",
           "MS-SSIM"]


def plot_metrics(metric_history: Dict[str, List[float]],
                 graph_dir: str) -> None:
    """``training_results.png`` and ``<metric>.png`` of ``metric_history``
    into ``graph_dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(graph_dir, exist_ok=True)
    if not metric_history or not any(metric_history.values()):
        logger.warning("No metric data available to plot.")
        return

    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    fig.suptitle("Training Results Summary", fontsize=16)
    axes = axes.flatten()
    for idx, (metric, title) in enumerate(zip(_METRICS, _TITLES)):
        series = metric_history.get(metric) or []
        if series:
            axes[idx].plot(range(1, len(series) + 1), series, linestyle="-")
            axes[idx].set_title(title)
            axes[idx].set_xlabel("Epoch")
            axes[idx].set_ylabel(title)
            axes[idx].grid(True)
        else:
            axes[idx].text(0.5, 0.5, "No data", ha="center", va="center")
    plt.tight_layout(rect=[0, 0, 1, 0.95])
    combined = os.path.join(graph_dir, "training_results.png")
    plt.savefig(combined)
    plt.close(fig)
    logger.info("Saved combined training results plot: %s", combined)

    for metric, title in zip(_METRICS, _TITLES):
        series = metric_history.get(metric) or []
        if not series:
            continue
        plt.figure(figsize=(10, 5))
        plt.plot(range(1, len(series) + 1), series, linestyle="-")
        plt.title(f"{title} Over Epochs")
        plt.xlabel("Epoch")
        plt.ylabel(title)
        plt.grid(True)
        plt.savefig(os.path.join(graph_dir, f"{metric}.png"))
        plt.close()
