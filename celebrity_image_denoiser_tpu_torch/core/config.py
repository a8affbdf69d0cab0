"""Global framework configuration.

The port's own copy of ``celebrity_image_denoiser_tpu/core/config.py`` (the
port imports nothing of the JAX package).  ``default_weights_dir`` climbs
three directory levels to the repo root, exactly like the original.

The reference hard-codes every constant inline (e.g. batch sizes / LRs at
reference backend/trainingcode/denoise_gan_code/training.py:239,497-506 and
interactive ``input()`` prompts for epoch counts at training.py:503).  Here the
same constants live in one documented dataclass layer that the CLIs expose as
flags.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class ComputeConfig:
    """Numerical execution configuration.

    compute_dtype: dtype activations/matmuls run in on device.  bfloat16 keeps
        the MXU fed at full rate; params stay float32.
    param_dtype: dtype parameters are stored in.
    """

    compute_dtype: str = "float32"
    param_dtype: str = "float32"


@dataclasses.dataclass
class TrainConfig:
    """Training hyper-parameters.

    Defaults reproduce the reference's denoise GAN configuration
    (training.py:239-242,497-506): Adam(1e-4, betas=(0.9, 0.999)),
    StepLR(step_size=30, gamma=0.1), batch 16, 256x256 images.
    """

    model: str = "denoise"
    batch_size: int = 16
    image_size: Tuple[int, int] = (256, 256)
    num_epochs: int = 20
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    step_lr_step_size: int = 30
    step_lr_gamma: float = 0.1
    adv_weight: float = 0.001  # training.py:424 g = content + 0.001 * adv
    seed: int = 0
    # cGAN (Keras path) uses G = BCE + 100 * MAE (training5Pbar.py:71-74)
    cgan_mae_weight: float = 100.0
    checkpoint_dir: str = "checkpoint"
    graph_dir: str = "graphs"
    test_image_dir: str = "testImage"
    noise_types: Sequence[str] = (
        "gaussian",
        "salt_pepper",
        "speckle",
        "poisson",
        "uniform",
    )
    test_split: float = 0.2  # training.py:115 test_split=0.2, seed 42 split
    split_seed: int = 42
    # on-the-fly, on-device noise augmentation instead of a pre-rendered
    # noisy dataset on disk (the TPU-native default; set False for parity
    # with the reference's disk-pair pipeline).
    on_the_fly_noise: bool = True
    # noise variant (1|2|3, data/noise.py); None → the variant the reference
    # uses for the model family (v1 denoise, v2 srgan/cgan, v3 esrgan)
    noise_variant: Optional[int] = None
    # rematerialize generator activations in backward (jax.checkpoint):
    # trades FLOPs for HBM to raise the trainable batch size
    remat: bool = False
    data_parallel: bool = True
    mesh_axis: str = "data"
    # metric evaluation on device every step (reference ping-pongs to CPU
    # per batch, training.py:378-392; we default to on-device).
    eval_on_device: bool = True
    # mixed precision: "bfloat16" runs model fwd/bwd in bf16 (f32 MXU accum,
    # f32 params/optimizer/losses); "float32" = full precision (default)
    compute_dtype: str = "float32"


# the noise variant each reference training pipeline uses (SURVEY.md §2:
# noise v1 denoise_gan, v2 srgan/cgan, v3 esrgan); dncnn (new) uses v1
FAMILY_NOISE_VARIANT = {
    "denoise": 1, "dncnn": 1, "srgan": 2, "cgan": 2, "esrgan": 3,
}


@dataclasses.dataclass
class ServeConfig:
    """Serving configuration mirroring reference backend/app.py limits."""

    host: str = "0.0.0.0"
    port: int = 8000
    max_upload_bytes: int = 50 * 1024 * 1024  # app.py:374-375
    weights_dir: str = "weights"


# Per-model serving configuration — mirrors MODEL_CFG at reference
# backend/app.py:228-233 exactly.
MODEL_CFG = {
    "denoise": {
        "normalize": ([0.5] * 3, [0.5] * 3),
        "activation": "tanh",
        "pad_divisor": 4,
        "scale": 1,
    },
    "cgan": {
        "normalize": ([0.5] * 3, [0.5] * 3),
        "activation": "tanh",
        "pad_divisor": 4,
        "scale": 1,
    },
    "srgan": {
        "normalize": ([0.5] * 3, [0.5] * 3),
        "activation": "tanh",
        "pad_divisor": 4,
        "scale": 4,
    },
    "esrgan": {
        "normalize": None,
        "activation": None,
        "pad_divisor": 4,
        "scale": 1,
    },
    # extension beyond the reference's four: blind-σ residual denoiser
    # (BASELINE config 3); [0,1] domain like esrgan
    "dncnn": {
        "normalize": None,
        "activation": None,
        "pad_divisor": 4,
        "scale": 1,
    },
}


def get_padding(
    size: Tuple[int, int], divisor: int, scale: int = 1
) -> Tuple[int, int, int, int]:
    """Zero-padding (left, top, right, bottom) to the next multiple of
    ``divisor * scale``.  Port of ``get_padding`` (reference app.py:276-281),
    taking ``(width, height)`` like ``PIL.Image.size``.
    """
    w, h = size
    eff = divisor * scale
    pad_w = (eff - w % eff) % eff
    pad_h = (eff - h % eff) % eff
    return (pad_w // 2, pad_h // 2, pad_w - pad_w // 2, pad_h - pad_h // 2)

def _looks_like_weights_dir(path: str) -> bool:
    """True when ``path`` holds at least one recognizable checkpoint: a
    ``.pth``/``.keras`` file, or a per-family npz dir (``<family>/`` or
    ``perceptual/``) that actually contains files.  Guards against an
    unrelated ./weights dir in the cwd silently routing serving/eval to
    random-init models."""
    import os

    try:
        entries = os.listdir(path)
    except OSError:
        return False
    families = set(MODEL_CFG) | {"perceptual"}
    for e in entries:
        if e.endswith((".pth", ".keras")):
            return True
        sub = os.path.join(path, e)
        if e in families and os.path.isdir(sub):
            try:
                if os.listdir(sub):
                    return True
            except OSError:
                continue
    return False


def default_weights_dir() -> str:
    """./weights if the cwd has one that actually contains checkpoints,
    else the repo-root weights/ shipped with the package — checkpoint
    consumers (serving, eval CLI, the default perceptual net) find the
    committed weights from any cwd, like the reference resolves weights/
    relative to backend/app.py:221.  A cwd ./weights with no recognizable
    checkpoint is skipped (with a log line) rather than shadowing the
    shipped weights."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    packaged = os.path.join(root, "weights")
    if os.path.isdir("weights") and os.path.abspath("weights") != packaged:
        if _looks_like_weights_dir("weights"):
            return "weights"
        from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

        get_logger("cid_torch.core.config").info(
            "ignoring cwd ./weights (no recognizable checkpoints); using "
            "packaged %s", packaged)
    if os.path.isdir("weights") and os.path.abspath("weights") == packaged:
        return "weights"
    return packaged if os.path.isdir(packaged) else "weights"
