"""celebrity_image_denoiser_tpu_torch — the PyTorch/CUDA port of
``celebrity_image_denoiser_tpu``, written for an NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
nothing of it (and never ``jax``).  What is ported so far: the five
served families behind ``POST /enhance`` (denoise, cgan with its Keras and
torch backends, srgan, esrgan, dncnn) in float32 and int8, the bf16
serving step the bench times, and the denoise GAN trainer (``cli.train``)
with on-the-fly noise.  The inference forward's 3×3 convolutions run through hand-written
CUDA kernels (``csrc/``, bound in ``ops/cuda/``) that port the Pallas kernels
``ops/pallas/conv_fused.py`` and ``ops/pallas/double_conv.py``; the training
input stage runs the port of ``ops/pallas/noise_kernel.py``.  The train step
itself differentiates through PyTorch's convs, as the JAX trainer
differentiates through XLA's.

Conventions
-----------
* Modules are logically NCHW (PyTorch's idiom, OIHW weights); on the card
  activations live in ``torch.channels_last`` so the kernels read NHWC
  memory without copies.
* The kernel entry points in ``ops/cuda/`` take NHWC tensors and HWIO
  weights, like their Pallas counterparts.
* Entry points (``ServeState``, ``cli.serve``, ``bench``, ``cli.train``,
  ``GANTrainer``, ``DataPipeline``) run on the card
  by default and raise when CUDA is absent; only an explicit
  ``device="cpu"`` runs on the CPU, where every kernel wrapper uses its
  plain PyTorch version.
"""

__version__ = "0.1.0"
