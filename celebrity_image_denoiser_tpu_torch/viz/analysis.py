"""Per-request analysis graphs.

Port of ``celebrity_image_denoiser_tpu/viz/analysis.py::make_graphs`` (:122),
itself the reference's ``make_graphs`` (app.py:302-313): a 3-panel
matplotlib figure — noise map (input − output, shifted to [0,1]), absolute
error map at 2× gain, and a 50-bin histogram of the differences — returned
as a base64 PNG with the same layout and titles.

The JAX package's pool of template figures is kept (artists built once,
data updated per request, checkout under a lock).  matplotlib is imported
only when a figure is first built, so ``graphs=false`` serving never needs
it, and the PNG is written by the stdlib codec of ``data/imageio.py``.
"""

from __future__ import annotations

import threading

import numpy as np

from celebrity_image_denoiser_tpu_torch.data.imageio import encode_png_base64


# imshow renders into a ~1500x500 px canvas; feeding it more pixels than
# that only slows the figure down — the panels are diagnostic, not
# pixel-exact.  The histogram still uses every pixel.
_MAX_PANEL_ROWS = 512

_HIST_BINS = 50  # reference app.py:309

# template pool: bounded so a burst of concurrent graph renders can't pin
# an unbounded number of ~30 MB Agg canvases
_POOL: list = []
_POOL_LOCK = threading.Lock()
_POOL_MAX = 8


def _panel_view(img: np.ndarray) -> np.ndarray:
    h = img.shape[0]
    if h <= _MAX_PANEL_ROWS:
        return img
    stride = -(-h // _MAX_PANEL_ROWS)  # ceil
    return img[::stride, ::stride]


class _FigureTemplate:
    """One reusable 3-panel figure: artists are created once, then only
    their data changes per request (set_data / bar heights)."""

    def __init__(self):
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        self.fig = Figure(figsize=(15, 5))
        self.canvas = FigureCanvasAgg(self.fig)
        axs = self.fig.subplots(1, 3)
        self.im_noise = axs[0].imshow(np.zeros((2, 2, 3), np.float32))
        axs[0].set_title("Noise Map (Input - Output)")
        axs[0].axis("off")
        self.im_err = axs[1].imshow(np.zeros((2, 2, 3), np.float32))
        axs[1].set_title("Absolute Error Map")
        axs[1].axis("off")
        self.hist_ax = axs[2]
        self.bars = self.hist_ax.bar(np.arange(_HIST_BINS),
                                     np.zeros(_HIST_BINS), width=1.0)
        self.hist_ax.set_title("Histogram of Noise Values")
        self.hist_ax.set_xlabel("Difference")
        self.hist_ax.set_ylabel("Frequency")
        self.fig.tight_layout()

    def render(self, noise: np.ndarray) -> str:
        panel = _panel_view(noise)
        h, w = panel.shape[:2]
        self.im_noise.set_data(np.clip(panel * 0.5 + 0.5, 0, 1))
        self.im_noise.set_extent((-0.5, w - 0.5, h - 0.5, -0.5))
        self.im_err.set_data(np.clip(np.abs(panel) * 2.0, 0, 1))
        self.im_err.set_extent((-0.5, w - 0.5, h - 0.5, -0.5))
        counts, edges = np.histogram(noise.ravel(), bins=_HIST_BINS)
        width = edges[1] - edges[0]
        for bar, c, e in zip(self.bars, counts, edges):
            bar.set_height(c)
            bar.set_x(e)
            bar.set_width(width)
        self.hist_ax.set_xlim(float(edges[0]), float(edges[-1]))
        self.hist_ax.set_ylim(0.0, float(max(counts.max(), 1)) * 1.05)
        self.canvas.draw()
        rgba = np.asarray(self.canvas.buffer_rgba())
        # RGB at zlib level 1 through the stdlib codec (no Pillow needed):
        # the figure is a transient diagnostic, encode speed wins
        return encode_png_base64(rgba[:, :, :3])


def make_graphs(input_vis: np.ndarray, output_vis: np.ndarray) -> str:
    """input_vis/output_vis: float HWC in [0,1] (the cropped view tensors).

    Thread-safe via a checkout pool of figure templates; see module
    docstring."""
    noise = (np.asarray(input_vis, np.float32)
             - np.asarray(output_vis, np.float32))
    with _POOL_LOCK:
        tmpl = _POOL.pop() if _POOL else None
    if tmpl is None:
        tmpl = _FigureTemplate()
    try:
        return tmpl.render(noise)
    finally:
        with _POOL_LOCK:
            if len(_POOL) < _POOL_MAX:
                _POOL.append(tmpl)
