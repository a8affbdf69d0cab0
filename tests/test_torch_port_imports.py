"""Rules every slice of the PyTorch/CUDA port inherits.

* Import hygiene: the port imports ``torch``, never ``jax``, and nothing of
  the JAX package ``celebrity_image_denoiser_tpu`` — not even its
  pure-Python modules.  Checked twice: a fresh interpreter imports every
  port module and must gain no ``jax*`` or JAX-package module, and a source
  scan finds no such import statement (the pattern must not match the
  port's own name, which shares the JAX package's name as a prefix).
  Nor ``h5py``, which the card machine does not have: the port reads
  Keras' HDF5 files itself (``ckpt/keras.py``).
* No quiet fallback: the entry points run on the card by default, and on a
  machine without CUDA (this one) they raise instead of running on the CPU.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "celebrity_image_denoiser_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
JAX_PKG_IMPORT = re.compile(
    r"^\s*(from|import)\s+celebrity_image_denoiser_tpu(?!_torch)\b", re.M)
JAX_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax)\b", re.M)
H5PY_IMPORT = re.compile(r"^\s*(from|import)\s+h5py\b", re.M)


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_port_has_modules_to_check():
    mods = _modules()
    assert "celebrity_image_denoiser_tpu_torch.serve.handlers" in mods
    # the training slice: every new module is imported and scanned below
    for name in ("ops.cuda.noise", "ops.norm", "ops.activations",
                 "data.noise", "data.synthetic", "data.datasets",
                 "data.pipeline", "ckpt.checkpoint", "train.losses",
                 "train.optim", "train.gan_trainer", "metrics.psnr_ssim",
                 "cli.train",
                 # the int8 serving slice
                 "ops.quant", "ops.quant_unet", "ops.cuda.conv3x3_s8",
                 "ops.cuda.convt2x2_s8",
                 # big inputs, micro-batching and the quality gate
                 "parallel", "parallel.tiling", "serve.batching",
                 "serve.quality",
                 # the dncnn, esrgan and srgan families
                 "models.dncnn", "models.esrgan", "models.srgan",
                 "models.folded", "models.registry", "ops.padding",
                 "ops.resize",
                 # the cgan family
                 "models.cgan", "models.cgan_torch", "ckpt.keras",
                 # the data layer and the noisy-dataset renderer
                 "data.imageio", "data.caching", "data.celeba", "data.native",
                 "data._native.build", "cli.noise_gen",
                 # training to the shipped file: metrics, QAT, export, CLIs
                 "metrics.msssim", "train.qat", "ckpt.export", "cli.qat",
                 "cli.export", "cli.eval", "cli.bench", "utils.profiling",
                 "viz.training_plots", "viz.side_by_side",
                 # multiple devices: the serving and training meshes
                 "parallel.mesh", "parallel.collectives",
                 "parallel.dataparallel", "dryrun"):
        assert f"celebrity_image_denoiser_tpu_torch.{name}" in mods, name
    assert len(PORT_FILES) > 35


def test_importing_every_port_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'celebrity_image_denoiser_tpu', "
        "'h5py'))\n"
        "assert not bad, bad\n"
        "print('ok', len(new))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_pattern_tells_the_two_packages_apart():
    assert JAX_PKG_IMPORT.search("from celebrity_image_denoiser_tpu.ops import x")
    assert JAX_PKG_IMPORT.search("import celebrity_image_denoiser_tpu")
    assert not JAX_PKG_IMPORT.search(
        "from celebrity_image_denoiser_tpu_torch.ops import x")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_neither_jax_nor_the_jax_package(path):
    text = path.read_text()
    assert not JAX_PKG_IMPORT.search(text), path
    assert not JAX_IMPORT.search(text), path
    assert not H5PY_IMPORT.search(text), path


# ---------------------------------------------------------------------------
# no quiet fallback onto the CPU
@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-fallback path needs none")


def test_serve_state_defaults_to_the_card(no_cuda):
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    with pytest.raises(RuntimeError, match="cuda"):
        ServeState()


def test_http_server_defaults_to_the_card(no_cuda):
    from celebrity_image_denoiser_tpu_torch.serve.app import make_server

    with pytest.raises(RuntimeError, match="cuda"):
        make_server("127.0.0.1", 0)


def test_cli_serve_defaults_to_the_card(no_cuda):
    from celebrity_image_denoiser_tpu_torch.cli import serve

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--quantize", "off", "--port", "0"])
    with pytest.raises(RuntimeError, match="cuda"):  # the int8 default too
        serve.main(["--port", "0"])


def test_cli_train_defaults_to_the_card(no_cuda, tmp_path):
    from celebrity_image_denoiser_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--clean-dir", str(tmp_path), "--num-epochs", "1"])


def test_cli_noise_gen_defaults_to_the_card(no_cuda, tmp_path):
    from celebrity_image_denoiser_tpu_torch.cli import noise_gen

    with pytest.raises(RuntimeError, match="cuda"):
        noise_gen.main(["--clean-dir", str(tmp_path), "--out-dir",
                        str(tmp_path / "out")])


def test_noise_kernel_never_falls_back_off_the_cpu(no_cuda):
    """A tensor that is neither on the CPU nor on a card raises; nothing
    routes it to the plain version."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import noise

    x = torch.zeros(1, 2, 2, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        noise.fused_normalize_gaussian_noise(0, x)


def test_bench_refuses_to_run_without_the_card(no_cuda):
    from celebrity_image_denoiser_tpu_torch import bench

    with pytest.raises(RuntimeError, match="cuda"):
        bench.main()
    with pytest.raises(ValueError):  # a CPU number is not a device metric
        bench.run(batch=1, device="cpu")


def test_serve_step_refuses_cuda_without_a_card(no_cuda):
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        DenoiseGenerator,
        serve_step,
    )

    model = DenoiseGenerator().to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_step(model, torch.zeros(1, 8, 8, 3, dtype=torch.uint8),
                   device="cuda")


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_the_card_or_the_repo(no_cuda, tmp_path,
                                                       alone):
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
