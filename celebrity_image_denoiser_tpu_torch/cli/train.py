"""Training CLI of the port (counterpart of
``celebrity_image_denoiser_tpu/cli/train.py``).

  # on-the-fly noise over a clean dataset, on the card
  python -m celebrity_image_denoiser_tpu_torch.cli.train --model denoise \\
      --clean-dir Clean_dataset --image-size 256 256 --batch-size 16 \\
      --num-epochs 20

  # the reference's disk pairs (rendered by cli.noise_gen)
  python -m celebrity_image_denoiser_tpu_torch.cli.train --model denoise \\
      --clean-dir Clean_dataset --noisy-dir Dataset_Noise --no-on-the-fly

  # a tensor-pair cache: the npz cache (data.caching.build_tensor_cache),
  # the reference's Pre_dataset .pt tree or its cGAN tf.data cache
  python -m celebrity_image_denoiser_tpu_torch.cli.train --model esrgan \\
      --tensor-cache cache_dir

  # srgan ×4: 256² HR crops, 64² LR inputs, the shipped VGG tower
  python -m celebrity_image_denoiser_tpu_torch.cli.train --model srgan \\
      --clean-dir Clean_dataset --image-size 256 256 --sr-scale 4

  # resume from the newest checkpoint under --checkpoint-dir
  python -m celebrity_image_denoiser_tpu_torch.cli.train ... --resume

  # data parallelism: one rank per card, --batch-size the global batch
  python -m torch.distributed.run --nproc-per-node 4 \
      -m celebrity_image_denoiser_tpu_torch.cli.train --model denoise ...

Every family trains: denoise, srgan, esrgan, cgan (the Keras generator and
discriminator, Keras Adam) and dncnn (no discriminator; the blind-σ
Gaussian unless ``--noise-variant`` is given).  srgan's content loss runs
on a torchvision VGG16 ``--vgg-pth``, else the shipped tower
(``weights/perceptual``), else random features with a loud warning.

The data comes one of three ways, chosen as the JAX CLI chooses
(``build_dataset``): clean files with the noise drawn on the card (the
default: one launch of the noise kernel a step, the clean batch resized to
``--image-size`` and carried as uint8); the pre-rendered disk pairs
(``--no-on-the-fly --noisy-dir``; srgan reads its LR noisy side at
``--image-size // --sr-scale``; esrgan and dncnn load on [0, 1], the rest
in [-1, 1]); or a tensor cache (``--tensor-cache``, whose numeric domain
follows ``--tensor-cache-domain``, the cache's ``meta.json`` or a probe,
and is remapped to the family's).  The last two launch no noise kernel.

``--extra-metrics batch`` fills the history's LPIPS and MS-SSIM columns from
every batch inside the step (``epoch`` samples a test pair, which the CLI
does not set, as in the JAX CLI: zeros); ``--remat`` recomputes the
generator's activations in the backward; ``--profile-dir`` runs the
training inside ``utils.profiling.trace`` (a Chrome trace, one per rank);
the history is plotted into ``--graph-dir`` at the end, or, where
matplotlib is missing, one warning says so and the run still succeeds.

Data parallelism (the JAX CLI's mesh over every chip, :130-134, 252-255):
launched by ``torch.distributed.run`` (its ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` in the environment), each rank trains on ``cuda:LOCAL_RANK``
over NCCL, or over gloo with ``--device cpu``, on its share of every
global batch of ``--batch-size`` (``GANTrainer(mesh=)``): the gradients and
BatchNorm statistics are the global batch's and rank 0 alone writes the
checkpoints and plots.  ``--no-data-parallel`` turns it off, as in JAX: it
is refused under a world size above 1 (that would be as many separate
trainings) and trains alone at world size 1.  A ``LOCAL_RANK`` without a
card of its own is refused; nothing falls back to gloo where NCCL is the
backend.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch
import torch.distributed as dist

from celebrity_image_denoiser_tpu_torch.core.config import TrainConfig
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data.caching import open_tensor_cache
from celebrity_image_denoiser_tpu_torch.data.datasets import (
    CleanImageDataset,
    PairedImageDataset,
)
from celebrity_image_denoiser_tpu_torch.data.pipeline import DataPipeline
from celebrity_image_denoiser_tpu_torch.metrics import PerceptualDistance
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.parallel.mesh import process_mesh
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
    FAMILIES,
    UNIT_FAMILIES,
    GANTrainer,
)
from celebrity_image_denoiser_tpu_torch.train.losses import (
    make_vgg_perceptual,
)
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger
from celebrity_image_denoiser_tpu_torch.utils.profiling import trace
from celebrity_image_denoiser_tpu_torch.viz.training_plots import (
    plot_metrics,
)

logger = get_logger("cid_torch.cli.train")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a GAN family on an NVIDIA card")
    p.add_argument("--model", default="denoise", choices=list(FAMILIES))
    p.add_argument("--clean-dir", default="Clean_dataset")
    p.add_argument("--noisy-dir", default="Dataset_Noise")
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--checkpoint-dir", default="checkpoint")
    p.add_argument("--graph-dir", default="graphs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-on-the-fly", action="store_true",
                   help="read pre-rendered noisy pairs from --noisy-dir "
                        "(reference-parity pipeline)")
    p.add_argument("--tensor-cache", default=None,
                   help="train from a tensor-pair cache dir: the npz cache "
                        "(data.caching.build_tensor_cache), the reference's "
                        "Pre_dataset .pt tree (<dir>/<noise>/{noisy,clean}"
                        "_tensor/*.pt) or its cGAN tf.data cache (needs "
                        "tensorflow) — detected by layout; implies "
                        "--no-on-the-fly")
    p.add_argument("--tensor-cache-domain", default=None,
                   choices=["unit", "tanh"],
                   help="numeric domain of a --tensor-cache: 'unit' = [0,1], "
                        "'tanh' = [-1,1]. For caches without meta.json the "
                        "declaration wins (otherwise the domain is probed "
                        "from sample pairs and the inference logged); for "
                        "caches WITH meta.json the recorded domain is "
                        "authoritative and a contradicting declaration is "
                        "an error")
    p.add_argument("--noise-variant", type=int, default=None,
                   choices=[1, 2, 3],
                   help="default: the variant the reference uses for the "
                        "model family (v1 denoise, v2 srgan/cgan, v3 "
                        "esrgan; dncnn: the blind-sigma Gaussian)")
    p.add_argument("--sr-scale", type=int, default=4,
                   help="srgan upscale factor (LR = image-size / scale)")
    p.add_argument("--vgg-pth", default=None,
                   help="torchvision vgg16 .pth for the srgan perceptual "
                        "loss; default: the shipped trained tower "
                        "(weights/perceptual) when present, else random "
                        "features with a loud warning")
    p.add_argument("--remat", action="store_true",
                   help="recompute the generator's activations in the "
                        "backward (torch.utils.checkpoint)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-data-parallel", action="store_true",
                   help="under torch.distributed.run, train this process "
                        "alone (refused at a world size above 1)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 (default): model forward and backward in "
                        "bf16 with float32 accumulation; parameters, "
                        "optimiser state, losses and metrics stay float32. "
                        "float32: the reference's numeric behaviour")
    p.add_argument("--extra-metrics", default="off",
                   choices=["off", "epoch", "batch"],
                   help="LPIPS-style + MS-SSIM history: 'batch' computes "
                        "them on every batch inside the step; 'epoch' "
                        "samples a held-out test pair once per epoch")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "training run into this directory "
                        "(utils/profiling.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is present) or "
                        "cpu")
    return p


def perceptual_loss(vgg_pth=None):
    """srgan's content loss (``cli/train.py:270-293`` of the JAX CLI): the
    torchvision tower of ``vgg_pth``, else ``PerceptualDistance.default()``
    (the shipped tower, else random features, with a warning)."""
    if vgg_pth:
        pd = PerceptualDistance.from_torchvision_pth(vgg_pth)
        logger.info("perceptual: torchvision VGG16 from %s", vgg_pth)
    else:
        pd = PerceptualDistance.default()
        if pd.pretrained:
            logger.info("perceptual: shipped trained tower "
                        "(weights/perceptual)")
        else:
            logger.warning(
                "perceptual: NO trained weights found — SRGAN's content "
                "loss will use RANDOM VGG features (pass --vgg-pth or ship "
                "weights/perceptual)")
    # the shipped tower was trained on [0, 1]; torchvision and random
    # towers keep the reference's unshifted feed
    return make_vgg_perceptual(pd.net, to_unit=pd.input_domain == "unit")


def build_modules(family, image_size, *, sr_scale=4, vgg_pth=None,
                  generator=None):
    """``(generator, discriminator or None, perceptual loss or None)`` of
    ``family`` at full width, as the JAX CLI builds them (:240-297): no
    discriminator for dncnn, esrgan's and cgan's sized for ``image_size``
    (their Linear widths depend on it), srgan ×``sr_scale`` with its
    content loss (``perceptual_loss``).  ``generator`` is the
    ``torch.Generator`` the initialisers draw from."""
    if family == "srgan":
        g = registry.build_generator("srgan", scale_factor=sr_scale,
                                     generator=generator)
    else:
        g = registry.build_generator(family, generator=generator)
    if family == "dncnn":
        d = None
    elif family in ("esrgan", "cgan"):
        d = registry.build_discriminator(family, input_hw=tuple(image_size),
                                         generator=generator)
    else:
        d = registry.build_discriminator(family, generator=generator)
    perceptual = perceptual_loss(vgg_pth) if family == "srgan" else None
    return g, d, perceptual


def resolve_cache_domain(dataset, declared, path: str) -> bool:
    """Set and return ``dataset.normalized`` (True: [-1, 1]) by the JAX
    CLI's rules (:148-213): a declared domain (``"unit"`` / ``"tanh"``)
    overrides an assumed one (the ``.pt`` reader's torchvision [0, 1]) and
    contradicting a domain recorded in ``meta.json`` is a ``ValueError``;
    with no declaration a cache without metadata is probed over up to 32
    pairs spread across it, with a warning that says how weak the evidence
    is."""
    if declared is not None:
        want = declared == "tanh"
        recorded = bool(getattr(dataset, "domain_recorded", False))
        if recorded and bool(dataset.normalized) != want:
            raise ValueError(
                f"--tensor-cache-domain={declared} contradicts the domain "
                f"recorded in {path}/meta.json "
                f"({'tanh' if dataset.normalized else 'unit'}); drop the "
                "flag or rebuild the cache if its metadata is wrong")
        if not recorded and dataset.normalized is not None \
                and bool(dataset.normalized) != want:
            logger.info("declared --tensor-cache-domain=%s overrides the "
                        "cache's assumed domain", declared)
        else:
            logger.info("using declared --tensor-cache-domain=%s", declared)
        dataset.normalized = want
    elif dataset.normalized is None:
        # a [-1, 1] cache has negative values with near certainty once
        # enough samples are seen: spread up to 32 probes across it
        n_probe = min(32, len(dataset))
        step = max(1, len(dataset) // n_probe)
        stats = [(float(min(a.min() for a in pair)),
                  float(max(a.max() for a in pair)))
                 for pair in (dataset[i] for i in range(0, len(dataset), step))
                 if pair is not None]
        if not stats:
            raise ValueError(
                f"--tensor-cache {path}: none of the {n_probe} probed pairs "
                "could be read, so its numeric domain can't be probed — fix "
                "the cache or pass --tensor-cache-domain explicitly")
        probe_min = min(s[0] for s in stats)
        probe_max = max(s[1] for s in stats)
        dataset.normalized = probe_min < -1e-3
        # nothing negative and nothing near 1.0: a dim [-1, 1] cache looks
        # the same
        ambiguous = not dataset.normalized and probe_max < 0.75
        logger.warning(
            "--tensor-cache has no meta.json; probed %d pairs (min %.4f, max "
            "%.4f) => INFERRING domain %s%s — pass --tensor-cache-domain or "
            "rebuild the cache to make this explicit",
            len(stats), probe_min, probe_max,
            "[-1,1]" if dataset.normalized else "[0,1]",
            ("; evidence is weak (no negatives seen but max stays well under "
             "1.0), the inference may be wrong" if ambiguous else ""))
    return bool(dataset.normalized)


class Remapped:
    """A pair dataset mapped between [0, 1] and [-1, 1]: ``to_tanh`` maps
    ``a·2 − 1``, else ``a·0.5 + 0.5``; None items stay None."""

    def __init__(self, base, to_tanh: bool):
        self.base = base
        self.to_tanh = to_tanh

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        pair = self.base[i]
        if pair is None:
            return None
        if self.to_tanh:
            return tuple(a * 2.0 - 1.0 for a in pair)
        return tuple(a * 0.5 + 0.5 for a in pair)


def build_dataset(args, cfg: TrainConfig):
    """The training dataset of ``args``, as the JAX CLI builds it
    (:136-257): a tensor cache in the family's domain, the disk pairs, or
    the clean files of the on-the-fly path."""
    zero_one_family = args.model in UNIT_FAMILIES
    if args.tensor_cache:
        dataset = open_tensor_cache(args.tensor_cache)
        tanh = resolve_cache_domain(dataset, args.tensor_cache_domain,
                                    args.tensor_cache)
        if tanh == zero_one_family:
            logger.info("remapping cached pairs to the %s family domain %s",
                        args.model, "[0,1]" if zero_one_family else "[-1,1]")
            dataset = Remapped(dataset, to_tanh=not zero_one_family)
        return dataset
    if cfg.on_the_fly_noise:
        return CleanImageDataset(
            args.clean_dir, image_size=cfg.image_size,
            test_split=cfg.test_split, split_seed=cfg.split_seed)
    # srgan's disk layout is LR noisy / HR clean; esrgan and dncnn pairs
    # load unnormalised ([0, 1], their train domain)
    lr_hw = None
    if args.model == "srgan":
        lr_hw = (cfg.image_size[0] // args.sr_scale,
                 cfg.image_size[1] // args.sr_scale)
    return PairedImageDataset(
        args.noisy_dir, args.clean_dir, cfg.noise_types,
        noisy_size=lr_hw or cfg.image_size, clean_size=cfg.image_size,
        test_split=cfg.test_split, split_seed=cfg.split_seed,
        normalize=not zero_one_family)


def build_config(args) -> TrainConfig:
    """The ``TrainConfig`` of parsed ``args``."""
    return TrainConfig(
        model=args.model,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        image_size=tuple(args.image_size),
        lr=args.lr,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        graph_dir=args.graph_dir,
        on_the_fly_noise=not args.no_on_the_fly and not args.tensor_cache,
        noise_variant=args.noise_variant,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
    )


def launched_by_torchrun() -> bool:
    """Whether this process is a rank that ``torch.distributed.run``
    started."""
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "LOCAL_RANK" in os.environ and "WORLD_SIZE" in os.environ)


@contextlib.contextmanager
def data_parallel(args):
    """The ``DeviceMesh`` of this rank's data-parallel run and its device
    (None and ``--device`` when not launched by ``torch.distributed.run``,
    or with ``--no-data-parallel`` at world size 1).  The process group is
    made here and destroyed on exit, unless the caller had initialised one
    already (a launcher of its own), which is then taken as it is."""
    owned = not dist.is_initialized()
    if owned and not launched_by_torchrun():
        yield None, resolve_device(args.device)
        return
    world = int(os.environ["WORLD_SIZE"]) if owned else dist.get_world_size()
    if args.no_data_parallel:
        if world > 1:
            raise SystemExit(
                f"--no-data-parallel with a world size of {world} would run "
                f"{world} separate trainings on the same files; launch one "
                "process instead")
        yield None, resolve_device(args.device)
        return
    device = resolve_device(args.device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise SystemExit(
                f"LOCAL_RANK={local} has no card: this machine has "
                f"{torch.cuda.device_count()} (NCCL takes one card a rank)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if owned:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    logger.info("data parallel: rank %d of %d over %s on %s",
                dist.get_rank(), dist.get_world_size(), dist.get_backend(),
                device)
    try:
        yield process_mesh(), device
    finally:
        if owned:
            dist.destroy_process_group()


def build_trainer(args, mesh=None, device=None) -> GANTrainer:
    """The trainer that ``run`` and ``main`` train; under ``mesh`` (a
    data-parallel run) on this rank's share of each batch."""
    device = device or resolve_device(args.device)
    cfg = build_config(args)
    rank, world = (0, 1) if mesh is None else (dist.get_rank(),
                                                dist.get_world_size())
    pipeline = DataPipeline(build_dataset(args, cfg), cfg.batch_size,
                            shuffle=True, seed=cfg.seed, drop_last=True,
                            device=device, rank=rank, world=world)
    gen, disc, perceptual = build_modules(
        args.model, cfg.image_size, sr_scale=args.sr_scale,
        vgg_pth=args.vgg_pth,
        generator=torch.Generator().manual_seed(cfg.seed))
    extra = False if args.extra_metrics == "off" else args.extra_metrics
    trainer = GANTrainer(gen, disc, pipeline, cfg, family=args.model,
                         perceptual=perceptual, extra_metrics=extra,
                         device=device, mesh=mesh)
    if args.resume:
        trainer.resume()
    return trainer


def plot_history(history, graph_dir: str) -> None:
    """``viz.training_plots.plot_metrics``, or one warning where matplotlib
    is missing."""
    try:
        plot_metrics(history, graph_dir)
    except ImportError as e:
        logger.warning("no training plots written to %s: %s is not "
                       "installed", graph_dir, e.name or e)


def run(argv=None) -> GANTrainer:
    """Parse ``argv``, train (inside a profiler trace with
    ``--profile-dir``; data-parallel under ``torch.distributed.run``), plot
    the history (rank 0), and return the trainer."""
    args = build_parser().parse_args(argv)
    with data_parallel(args) as (mesh, device):
        trainer = build_trainer(args, mesh, device)
        if args.profile_dir:
            with trace(args.profile_dir):
                trainer.train()
        else:
            trainer.train()
    if trainer.rank == 0:
        plot_history(trainer.metric_history, args.graph_dir)
    return trainer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
