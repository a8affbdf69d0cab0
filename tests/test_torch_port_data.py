"""The port's data layer against the JAX package, on the CPU.

Small trees made with numpy in a temporary directory (PNGs, one JPEG, one
corrupt file; sizes on both sides of the 32² target) go through each JAX
function and its counterpart in the port:

* ``imageio``: ``imread_rgb``'s bicubic and lanczos bit-equal to JAX's
  (Pillow's), its cv2-linear equal to JAX's path without cv2 (at most 1
  count, on at most 0.1% of the values), ``imwrite``, ``list_images``;
  ``ops.resize(..., "linear")`` within 1e-5 of JAX's;
* ``datasets``: pairing, both splits and every item bit-equal (normalised
  or not, srgan's LR/HR sides, None for a corrupt file); the clean dataset
  resized to the uint8 that JAX holds before ``to_float01``;
* ``caching``: the npz cache and its ``meta.json`` identical, each reader on
  the other package's cache, the reference's ``.pt`` tree and a tf.data
  cache, ``validate_dataset``'s scopes, and the ``--tensor-cache-domain``
  rules case by case against the JAX CLI's own logic;
* ``cli.noise_gen``: the tree and the clean HR copies equal to the JAX
  renderer's, the noise held to JAX's by distribution per type, one call of
  the noise kernel's entry per (batch, type) and variant 3's poisson on
  ``poisson_v3_exact``;
* the native stage: the port's build equal to JAX's, within 1e-5 of the
  loader's own plan in numpy, within Pillow's bounds, and its uint8 batch
  within 1/255 of JAX's float batch (a difference kept by design); the
  pipeline's native path and its refusals;
* ``celeba.prepare_clean_dataset``, ``heldout_noisy_batch`` and
  ``cli.train`` on disk pairs and on a cache, with resume.
"""

import json
import os
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from celebrity_image_denoiser_tpu import ops as jax_ops
from celebrity_image_denoiser_tpu.cli import noise_gen as jax_noise_gen
from celebrity_image_denoiser_tpu.cli import train as jax_cli_train
from celebrity_image_denoiser_tpu.data import caching as jax_caching
from celebrity_image_denoiser_tpu.data import celeba as jax_celeba
from celebrity_image_denoiser_tpu.data import datasets as jax_datasets
from celebrity_image_denoiser_tpu.data import imageio as jax_io
from celebrity_image_denoiser_tpu.data import native as jax_native
from celebrity_image_denoiser_tpu.data import noise as jax_noise
from celebrity_image_denoiser_tpu.data.pipeline import (
    DataPipeline as JaxPipeline,
)
from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as port_ckpt
from celebrity_image_denoiser_tpu_torch.cli import noise_gen
from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
from celebrity_image_denoiser_tpu_torch.data import caching, celeba, datasets
from celebrity_image_denoiser_tpu_torch.data import imageio, native, synthetic
from celebrity_image_denoiser_tpu_torch.data import noise as port_noise
from celebrity_image_denoiser_tpu_torch.data.pipeline import DataPipeline
from celebrity_image_denoiser_tpu_torch.ops.cuda import noise as noise_kernel
from celebrity_image_denoiser_tpu_torch.ops.resize import resize

TYPES = port_noise.NOISE_TYPES
SIZES = [(32, 32), (40, 36), (28, 30), (33, 31), (64, 48), (24, 40)]


def _write_tree(root, seed=0):
    """Two persons × the SIZES as PNGs, one JPEG and one corrupt file."""
    rng = np.random.default_rng(seed)
    for p in range(2):
        d = os.path.join(root, f"person{p}")
        os.makedirs(d)
        for i, (h, w) in enumerate(SIZES):
            imageio.imwrite(os.path.join(d, f"{i}.png"),
                            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (36, 44, 3), dtype=np.uint8)).save(
        os.path.join(root, "person0", "face.jpg"), quality=95)
    with open(os.path.join(root, "person1", "broken.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot a png")
    return root


def _rels(root):
    return sorted(os.path.relpath(p, root) for p in imageio.list_images(root))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The clean tree; both renderers on it in srgan's layout at variant 1
    with the LR size equal to the HR size (the resize is then the identity
    in both, so the noise is compared pixel by pixel, and the clean HR
    copies are written); and the port's own render at 16² LR, variant 2
    (one JAX render: each costs ~10 s of compiles on this CPU)."""
    base = tmp_path_factory.mktemp("data")
    clean = _write_tree(str(base / "clean"))
    argv = ["--clean-dir", clean, "--image-size", "32", "32", "--batch",
            "16", "--seed", "3"]
    v1 = argv + ["--lr-size", "32", "32"]
    assert jax_noise_gen.main(v1 + ["--out-dir", str(base / "jax_v1")]) == 0
    assert noise_gen.main(v1 + ["--out-dir", str(base / "port_v1"),
                                "--device", "cpu"]) == 0
    assert noise_gen.main(argv + ["--variant", "2", "--lr-size", "16", "16",
                                  "--out-dir", str(base / "port_lr"),
                                  "--device", "cpu"]) == 0
    return {"base": base, "clean": clean,
            "v1": (str(base / "jax_v1"), str(base / "port_v1")),
            "lr": str(base / "port_lr")}


# ---------------------------------------------------------------------------
# imageio and ops.resize
@pytest.mark.parametrize("method", ["bicubic", "lanczos"])
@pytest.mark.parametrize("name", ["person0/4.png", "person0/face.jpg"])
def test_imread_resize_bit_equal_to_jax(tree, method, name):
    """Pillow's BICUBIC and LANCZOS, bit for bit, up and down, from a path
    and from bytes."""
    path = os.path.join(tree["clean"], name)
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(imageio.imread_rgb(path),
                                  jax_io.imread_rgb(path))
    for size in [(32, 32), (20, 28), (96, 80), (7, 5)]:
        want = jax_io.imread_rgb(path, size, method=method)
        np.testing.assert_array_equal(
            imageio.imread_rgb(path, size, method=method), want)
        np.testing.assert_array_equal(
            imageio.imread_rgb(data, size, method=method), want)


def test_cv2_linear_is_the_jax_path_without_cv2(tree):
    """The triangle filter without antialias, rounded: the JAX function's
    path when cv2 cannot be imported (the port never imports it), within 1
    count on at most 0.5% of the values (values at a half count round by
    the last bit of the two float sums).  Where cv2 is installed the JAX
    function runs cv2's fixed-point kernel instead: within 1 count, on
    about 12% of the values (``data/imageio.py:44-49`` of the JAX
    package)."""
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    for name in ("person0/4.png", "person0/face.jpg", "person1/1.png"):
        path = os.path.join(tree["clean"], name)
        for size in [(32, 32), (20, 28), (96, 80)]:
            got = imageio.imread_rgb(path, size, method="cv2-linear")
            with mock.patch.dict(sys.modules, {"cv2": None}):
                want = jax_io.imread_rgb(path, size, method="cv2-linear")
            assert got.shape == want.shape and got.dtype == np.uint8
            d = np.abs(got.astype(int) - want)
            assert d.max() <= 1 and (d > 0).mean() <= 5e-3
            if have_cv2:
                d = np.abs(got.astype(int) - jax_io.imread_rgb(
                    path, size, method="cv2-linear"))
                assert d.max() <= 1 and (d > 0).mean() <= 0.2
    with pytest.raises(ValueError, match="unknown resize method"):
        imageio.imread_rgb(path, (8, 8), method="area")


@pytest.mark.parametrize("antialias", [True, False])
def test_resize_linear_matches_jax(antialias):
    x = np.random.default_rng(2).random((2, 40, 36, 3)).astype(np.float32)
    for size in [(32, 32), (20, 50), (80, 72)]:
        want = np.asarray(jax_ops.resize(x, size, "linear",
                                         antialias=antialias))
        got = resize(torch.from_numpy(x), size, "linear",
                     antialias=antialias).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_imwrite_and_list_images(tree, tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (9, 11, 3), np.uint8)
    imageio.imwrite(str(tmp_path / "a.png"), img)   # the port's encoder
    jax_io.imwrite(str(tmp_path / "b.jpg"), img)
    imageio.imwrite(str(tmp_path / "c.jpg"), img)   # through PIL
    np.testing.assert_array_equal(imageio.imread_rgb(str(tmp_path / "a.png")),
                                  img)
    assert (tmp_path / "b.jpg").read_bytes() == \
        (tmp_path / "c.jpg").read_bytes()
    assert imageio.list_images(tree["clean"]) == jax_io.list_images(
        tree["clean"])


# ---------------------------------------------------------------------------
# datasets
def test_pairs_and_splits_equal_jax(tree):
    jax_dir, _ = tree["v1"]
    pairs = datasets.collect_pairs(jax_dir, tree["clean"], TYPES)
    assert pairs == jax_datasets.collect_pairs(jax_dir, tree["clean"], TYPES)
    assert len(pairs) == 5 * 13  # 13 decodable clean files per type
    assert datasets.train_test_split_pairs(pairs) == \
        jax_datasets.train_test_split_pairs(pairs)
    for seed in (None, 7):
        if seed is None:  # the reference's unseeded split: sizes only
            got = datasets.train_val_test_split(pairs)
            assert [len(s) for s in got] == [52, 6, 7]
            continue
        assert datasets.train_val_test_split(pairs, seed=seed) == \
            jax_datasets.train_val_test_split(pairs, seed=seed)
        assert caching.train_val_test_split(pairs, seed=seed) == \
            jax_caching.train_val_test_split(pairs, seed=seed)
    with pytest.raises(ValueError):
        datasets.train_val_test_split([])


@pytest.mark.parametrize("kw", [
    dict(image_size=(32, 32), normalize=True),
    dict(image_size=(24, 20), normalize=False),
    dict(noisy_size=(16, 16), clean_size=(32, 32), normalize=True),  # srgan
], ids=["tanh", "unit", "srgan"])
def test_paired_dataset_items_bit_equal(tree, kw):
    jax_dir = tree["v1"][0] if "image_size" in kw else tree["lr"]
    port = datasets.PairedImageDataset(jax_dir, tree["clean"], **kw)
    ref = jax_datasets.PairedImageDataset(jax_dir, tree["clean"], **kw)
    assert port.image_pairs == ref.image_pairs
    assert port.test_image_pairs == ref.test_image_pairs
    assert [tuple(s) for s in port.raw_batch_spec] == \
        [tuple(s) for s in ref.raw_batch_spec]
    for i in range(0, len(port), 5):
        for a, b in zip(port[i], ref[i]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        for a, b in zip(port.raw(i), ref.raw(i)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(port.get_test(0), ref.get_test(0)):
        np.testing.assert_array_equal(a, b)
    if "noisy_size" in kw:
        assert port[0][0].shape == (16, 16, 3)
        assert port[0][1].shape == (32, 32, 3)


def test_paired_dataset_skips_a_corrupt_file(tree, tmp_path):
    noisy = str(tmp_path / "noisy")
    shutil.copytree(tree["v1"][0], noisy)
    port = datasets.PairedImageDataset(noisy, tree["clean"],
                                       image_size=(32, 32))
    bad = port.image_pairs[3][0]
    with open(bad, "wb") as f:
        f.write(b"garbage")
    ref = jax_datasets.PairedImageDataset(noisy, tree["clean"],
                                          image_size=(32, 32))
    assert port[3] is None and ref[3] is None
    assert port.raw(3) is None and port[4] is not None


def test_clean_dataset_resizes_to_the_jax_uint8(tree):
    """uint8 at image_size, Pillow's bicubic: ``to_float01`` of it is JAX's
    item bit for bit (normalize off), its [-1, 1] form JAX's normalised
    item; the corrupt file gives None in both."""
    port = datasets.CleanImageDataset(tree["clean"], image_size=(32, 28))
    ref = jax_datasets.CleanImageDataset(tree["clean"], image_size=(32, 28))
    tanh = jax_datasets.CleanImageDataset(tree["clean"], image_size=(32, 28),
                                          normalize=True)
    assert port.train_paths == ref.train_paths
    assert port.raw_batch_spec == [((32, 28), None, None)]
    nones = 0
    for i in range(len(port)):
        x = port[i]
        if x is None:
            assert ref[i] is None
            nones += 1
            continue
        assert x.dtype == np.uint8 and x.shape == (32, 28, 3)
        np.testing.assert_array_equal(imageio.to_float01(x), ref[i])
        np.testing.assert_array_equal(
            imageio.normalize(imageio.to_float01(x)), tanh[i])
        np.testing.assert_array_equal(port.raw(i), ref.raw(i))
    assert nones == ("person1/broken.png" in
                     [os.path.relpath(p, tree["clean"])
                      for p in port.train_paths])
    assert datasets.CleanImageDataset(tree["clean"],
                                      image_size=None).raw_batch_spec is None


# ---------------------------------------------------------------------------
# caching
@pytest.mark.parametrize("method", ["bicubic", "lanczos", "cv2-linear"])
def test_build_tensor_cache_identical(tree, tmp_path, method):
    noisy = os.path.join(tree["v1"][0], "gaussian")
    kw = dict(image_size=(24, 32), normalize=method == "lanczos",
              resize_method=method)
    n = caching.build_tensor_cache(noisy, tree["clean"], str(tmp_path / "p"),
                                   **kw)
    with mock.patch.dict(sys.modules, {"cv2": None}):  # JAX without cv2
        assert n == jax_caching.build_tensor_cache(noisy, tree["clean"],
                                                   str(tmp_path / "j"), **kw)
    assert n == 13
    assert (tmp_path / "p" / "meta.json").read_text() == \
        (tmp_path / "j" / "meta.json").read_text()
    files = sorted(os.listdir(tmp_path / "p" / "pairs"))
    assert files == sorted(os.listdir(tmp_path / "j" / "pairs"))
    step = 2 / 255 if kw["normalize"] else 1 / 255
    for f in files:
        with np.load(tmp_path / "p" / "pairs" / f) as a, \
                np.load(tmp_path / "j" / "pairs" / f) as b:
            for k in ("noisy", "clean"):
                if method != "cv2-linear":
                    np.testing.assert_array_equal(a[k], b[k])
                    continue
                # a count apart on the values at a half count (above)
                d = np.abs(a[k] - b[k])
                assert d.max() <= step * 1.0001 and (d > 0).mean() <= 5e-3
    # each reader on the other package's cache
    for mine, other in ((caching.TensorPairDataset(str(tmp_path / "j")),
                         jax_caching.TensorPairDataset(str(tmp_path / "j"))),
                        (caching.TensorPairDataset(str(tmp_path / "p")),
                         jax_caching.TensorPairDataset(str(tmp_path / "p")))):
        assert len(mine) == len(other) == n
        assert (mine.normalized, mine.domain_recorded) == \
            (other.normalized, other.domain_recorded) == (kw["normalize"],
                                                          True)
        for a, b in zip(mine[n - 1], other[n - 1]):
            np.testing.assert_array_equal(a, b)


def _pt_tree(root, n=6, seed=0, scale=1.0):
    """The reference's Pre_dataset tree: ``<noise>/{noisy,clean}_tensor/
    <person>/<i>.pt``, CHW float tensors on [0, scale]."""
    rng = np.random.default_rng(seed)
    for noise in ("gaussian", "speckle"):
        for i in range(n):
            pair = rng.random((2, 3, 16, 16)).astype(np.float32) * scale
            for side, arr in zip(("noisy_tensor", "clean_tensor"), pair):
                d = os.path.join(root, noise, side, f"p{i % 2}")
                os.makedirs(d, exist_ok=True)
                torch.save(torch.from_numpy(arr), os.path.join(d, f"{i}.pt"))
    return root


def test_torch_pt_tree_reader(tmp_path):
    root = _pt_tree(str(tmp_path / "Pre_dataset"))
    os.remove(os.path.join(root, "speckle", "clean_tensor", "p1", "3.pt"))
    with open(os.path.join(root, "gaussian", "noisy_tensor", "p0", "2.pt"),
              "wb") as f:
        f.write(b"not a tensor")
    port = caching.open_tensor_cache(root)
    ref = jax_caching.open_tensor_cache(root)
    assert isinstance(port, caching.TorchTensorPairDataset)
    assert port.pairs == ref.pairs and len(port) == 11
    assert (port.normalized, port.domain_recorded) == (False, False)
    for i in range(len(port)):
        if ref[i] is None:
            assert port[i] is None
            continue
        for a, b in zip(port[i], ref[i]):
            assert a.shape == (16, 16, 3)
            np.testing.assert_array_equal(a, b)
    one = caching.TorchTensorPairDataset(os.path.join(root, "speckle"))
    assert one.pairs == jax_caching.TorchTensorPairDataset(
        os.path.join(root, "speckle")).pairs


def test_tf_data_cache_reader(tmp_path):
    """A DataP2-style cache made in-process with tf.data (tensorflow is
    imported here only: the card machine has none)."""
    import tensorflow as tf

    rng = np.random.default_rng(3)
    clean = rng.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.1, clean.shape),
                    -1, 1).astype(np.float32)
    path = str(tmp_path / "tfcache")
    tf.data.Dataset.from_tensor_slices((noisy, clean)).save(path)
    port = caching.open_tensor_cache(path)
    ref = jax_caching.open_tensor_cache(path)
    assert isinstance(port, caching.TFDataCacheDataset)
    assert (port.normalized, port.domain_recorded) == (True, True)
    assert len(port) == len(ref) == 5
    for i in range(5):
        for a, b, c in zip(port[i], ref[i], (noisy[i], clean[i])):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_validate_dataset_reports_and_deletes_by_scope(tree, tmp_path):
    """The report equals JAX's; nothing is deleted by default, and each
    destructive scope deletes only its own files."""
    for scope in ({}, {"delete_corrupt": True}, {"delete_unmatched": True}):
        results = []
        for pkg in (caching, jax_caching):
            base = tmp_path / f"{pkg.__name__.split('.')[0]}_{len(scope)}" \
                / next(iter(scope), "report")
            noisy, clean = str(base / "noisy"), str(base / "clean")
            shutil.copytree(os.path.join(tree["v1"][0], "speckle"), noisy)
            shutil.copytree(tree["clean"], clean)
            os.remove(os.path.join(noisy, "person0", "2.png"))
            with open(os.path.join(noisy, "person1", "broken.png"),
                      "wb") as f:
                f.write(b"junk")
            report = pkg.validate_dataset(noisy, clean, **scope)
            results.append(({k: [os.path.relpath(p, str(base))
                                 if os.path.isabs(p) else p for p in v]
                             for k, v in report.items()},
                            _rels(noisy), _rels(clean)))
        assert results[0] == results[1]
        report = results[0][0]
        assert report["unmatched_clean"] == ["person0/2.png"]
        assert report["corrupt"] == ["clean/person1/broken.png",
                                     "noisy/person1/broken.png"]
        want_deleted = {"report": [], "delete_corrupt": report["corrupt"],
                        "delete_unmatched": ["clean/person0/2.png"]}
        assert report["deleted"] == want_deleted[next(iter(scope),
                                                      "report")]


def _make_caches(base):
    """Caches for the domain rules: npz with recorded [0, 1] and [-1, 1],
    npz without meta.json holding [-1, 1] or dim [0, 0.5] values, one whose
    pairs are all unreadable, and the .pt tree (assumed [0, 1])."""
    rng = np.random.default_rng(9)
    out = {}
    for name, lo, hi, meta in (("meta_unit", 0, 1, False),
                               ("meta_tanh", -1, 1, True),
                               ("nometa_tanh", -1, 1, None),
                               ("nometa_dim", 0, 0.5, None),
                               ("nometa_broken", 0, 1, None)):
        d = os.path.join(base, name)
        os.makedirs(os.path.join(d, "pairs"))
        for i in range(6):
            path = os.path.join(d, "pairs", f"{i:06d}.npz")
            if name == "nometa_broken":
                with open(path, "wb") as f:
                    f.write(b"junk")
                continue
            pair = rng.uniform(lo, hi, (2, 16, 16, 3)).astype(np.float32)
            np.savez(path, noisy=pair[0], clean=pair[1])
        if meta is not None:
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump({"normalize": meta, "image_size": [16, 16],
                           "resize_method": "bicubic"}, f)
        out[name] = d
    out["pt"] = _pt_tree(os.path.join(base, "pt"))
    return out


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    return _make_caches(str(tmp_path_factory.mktemp("caches")))


def _jax_dataset(argv):
    """The dataset the JAX CLI trains on for ``argv``: its main runs up to
    the trainer, which is replaced by one that keeps the pipeline's
    dataset."""
    seen = {}

    class Keep:
        def __init__(self, gen, disc, pipeline, cfg, **kw):
            seen["dataset"] = pipeline.dataset

        def train(self):
            return {}

    with mock.patch.object(jax_cli_train, "GANTrainer", Keep), \
            mock.patch.object(jax_cli_train, "plot_metrics",
                              lambda *a, **k: None):
        jax_cli_train.main(argv + ["--compilation-cache", "off",
                                   "--no-data-parallel"])
    return seen["dataset"]


def _port_dataset(argv):
    args = cli_train.build_parser().parse_args(argv + ["--device", "cpu"])
    return cli_train.build_dataset(args, cli_train.build_config(args))


DOMAIN_CASES = [  # cache, family, declared, remapped (None: a ValueError)
    ("meta_unit", "denoise", None, True),
    ("meta_unit", "esrgan", None, False),
    ("meta_unit", "denoise", "tanh", None),
    ("meta_tanh", "esrgan", "unit", None),
    ("meta_tanh", "denoise", "tanh", False),
    ("nometa_tanh", "esrgan", None, True),
    ("nometa_dim", "denoise", None, True),
    ("nometa_dim", "denoise", "tanh", False),
    ("nometa_broken", "esrgan", None, None),
    ("pt", "denoise", None, True),
    ("pt", "denoise", "tanh", False),
    ("pt", "esrgan", "unit", False),
]


@pytest.mark.parametrize("cache,family,declared,remapped", DOMAIN_CASES,
                         ids=["-".join(map(str, c[:3])) for c in DOMAIN_CASES])
def test_tensor_cache_domain_rules_match_the_jax_cli(caches, caplog, cache,
                                                     family, declared,
                                                     remapped):
    argv = ["--model", family, "--tensor-cache", caches[cache],
            "--image-size", "16", "16"]
    if declared:
        argv += ["--tensor-cache-domain", declared]
    if remapped is None:
        for build in (_jax_dataset, _port_dataset):
            with pytest.raises(ValueError):
                build(argv)
        return
    ref = _jax_dataset(argv)
    with caplog.at_level("WARNING"):
        got = _port_dataset(argv)
    assert isinstance(got, cli_train.Remapped) == remapped
    assert len(got) == len(ref)
    for i in range(len(got)):
        for a, b in zip(got[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    if cache == "nometa_dim" and declared is None:
        assert "evidence is weak" in caplog.text


# ---------------------------------------------------------------------------
# noise: the renderer and poisson_v3_exact
def _type_diffs(out_dir, clean_dir, kind, size):
    """Noisy − clean over the PNGs of one type, as int."""
    diffs = []
    for rel in _rels(os.path.join(out_dir, kind)):
        if not rel.endswith(".png"):
            continue
        noisy = imageio.imread_rgb(os.path.join(out_dir, kind, rel))
        clean = imageio.imread_rgb(os.path.join(clean_dir, rel), size)
        diffs.append((noisy.astype(np.int64), clean.astype(np.int64)))
    return diffs


def test_noise_gen_tree_and_noise_match_jax(tree):
    """Same files at the same relative paths (the JPEG stays a JPEG, the
    corrupt file is skipped); per type, the noise by distribution: the mean
    and σ of noisy − clean, and the shares of 0 and 255 (salt and pepper,
    clipping) within 5 standard errors (plus 0.3 counts, 2% of σ)."""
    jax_dir, port_dir = tree["v1"]
    assert _rels(port_dir) == _rels(jax_dir)
    assert sorted(os.listdir(port_dir)) == sorted(TYPES + ("clean_hr",))
    assert "person0/face.jpg" in _rels(os.path.join(port_dir, "gaussian"))
    assert "person1/broken.png" not in _rels(os.path.join(port_dir,
                                                          "uniform"))
    for kind in TYPES:
        sides = []
        for out in (port_dir, jax_dir):
            pairs = _type_diffs(out, tree["clean"], kind, (32, 32))
            noisy = np.concatenate([n.ravel() for n, _ in pairs])
            clean = np.concatenate([c.ravel() for _, c in pairs])
            sides.append((noisy - clean, noisy))
        (dp, np_), (dj, nj) = sides
        n = dp.size
        assert abs(dp.mean() - dj.mean()) < 5 * dj.std() / np.sqrt(n) + 0.3, \
            kind
        assert abs(dp.std() - dj.std()) < 0.02 * dj.std() + 0.3, kind
        for v in (0, 255):
            p = (nj == v).mean()
            assert abs((np_ == v).mean() - p) < \
                5 * np.sqrt(p * (1 - p) / n) + 2e-3, (kind, v)


def test_noise_gen_clean_hr_copies_match_jax(tree):
    """srgan's layout: the clean HR copies bit for bit the JAX renderer's
    (its ``clip(x/255·255)`` truncation included), and the port's 16² LR
    render: every type's files at 16², at the clean files' paths."""
    jax_dir, port_dir = tree["v1"]
    hr = _rels(os.path.join(port_dir, "clean_hr"))
    assert hr == _rels(os.path.join(jax_dir, "clean_hr")) and len(hr) == 13
    for rel in hr:
        np.testing.assert_array_equal(
            imageio.imread_rgb(os.path.join(port_dir, "clean_hr", rel)),
            imageio.imread_rgb(os.path.join(jax_dir, "clean_hr", rel)))
    assert _rels(tree["lr"]) == _rels(port_dir)
    for kind in TYPES:
        for rel in _rels(os.path.join(tree["lr"], kind)):
            img = imageio.imread_rgb(os.path.join(tree["lr"], kind, rel))
            assert img.shape == (16, 16, 3)


def test_noise_gen_one_kernel_call_per_batch_and_type(tree, tmp_path):
    """Each (batch, type) is one call of the kernel's entry, every sample
    that type, on [0, 1], its seed from the renderer's generator; the files
    are the truncation of that output; variant 3's poisson goes through
    ``poisson_v3_exact`` instead, image by image."""
    calls, outs = [], []
    real = noise_kernel.noise_batch
    lr = str(tmp_path / "lr")

    def counted(kinds, seed, x, types, variant, domain):
        calls.append((kinds.clone(), seed.clone(), x.clone(), types,
                      variant, domain))
        out = real(kinds, seed, x, types, variant, domain)
        outs.append(out[0])
        return out

    exact = []
    real_exact = port_noise.poisson_v3_exact

    def counted_exact(gen, img):
        exact.append(port_noise.v3_poisson_vals(img))
        return real_exact(gen, img)

    with mock.patch.object(noise_kernel, "noise_batch", counted), \
            mock.patch.object(port_noise, "poisson_v3_exact", counted_exact):
        for variant in (1, 3):
            assert noise_gen.main(
                ["--clean-dir", tree["clean"], "--out-dir",
                 str(tmp_path / f"v{variant}"), "--image-size", "16", "16",
                 "--batch", "5", "--variant", str(variant),
                 "--device", "cpu"]) == 0
        # srgan's layout: the noisy batch downscaled, then truncated
        assert noise_gen.main(
            ["--clean-dir", tree["clean"], "--out-dir", lr, "--image-size",
             "16", "16", "--batch", "5", "--types", "speckle", "--lr-size",
             "8", "6", "--device", "cpu"]) == 0
    batches = 3  # 14 files in chunks of 5, one skipped
    assert len(calls) == 5 * batches + 4 * batches + batches
    assert len(exact) == 13  # variant 3's poisson, one per image
    assert all(v in (2.0 ** k for k in range(1, 9)) for v in exact)
    for j, (kinds, seed, x, types, variant, domain) in enumerate(calls[:27]):
        assert types == (TYPES[j % 5] if j < 15 else
                         [t for t in TYPES if t != "poisson"][(j - 15) % 4],)
        assert domain == "unit" and variant == (1 if j < 15 else 3)
        assert kinds.tolist() == [0] * x.shape[0]
        np.testing.assert_array_equal(
            outs[j], noise_kernel.noise_batch_plain(kinds, seed, x, types,
                                                    variant, "unit")[0])
    # the first batch's files: clip(noisy·255) truncated
    first = calls[0]
    rels = _rels(tree["clean"])[:5]
    want = torch.clamp(outs[0] * 255.0, 0, 255).to(torch.uint8).numpy()
    for i, rel in enumerate(rels):
        if rel.endswith(".png"):
            np.testing.assert_array_equal(imageio.imread_rgb(
                str(tmp_path / "v1" / first[3][0] / rel)), want[i])
    assert len({int(c[1]) for c in calls[:15]}) == 15  # a seed per call
    want = resize(outs[27], (8, 6), "bicubic")
    want = torch.clamp(want * 255.0, 0, 255).to(torch.uint8).numpy()
    for i, rel in enumerate(rels):
        if rel.endswith(".png"):
            np.testing.assert_array_equal(
                imageio.imread_rgb(os.path.join(lr, "speckle", rel)), want[i])


def test_poisson_v3_exact_distribution():
    """Pois(x·vals)/vals with vals from the image: on an image of 3 values
    (vals 4) the outputs are multiples of 1/4, mean x, variance x/4,
    clipped to [0, 1]; JAX's function the same by these statistics."""
    img = np.tile(np.array([0.2, 0.4, 0.6], np.float32), (64, 64, 1))
    assert port_noise.v3_poisson_vals(torch.from_numpy(img)) == 4.0
    got = port_noise.poisson_v3_exact(torch.Generator().manual_seed(0),
                                      torch.from_numpy(img)).numpy()
    want = np.asarray(jax_noise.poisson_v3_exact(jax.random.PRNGKey(0), img))
    assert np.all(got * 4 == np.round(got * 4)) and got.max() <= 1.0
    for c, lam in enumerate((0.2, 0.4, 0.6)):
        for out in (got, want):
            vals = out[..., c]
            clipped_mean = np.mean(np.minimum(
                np.random.default_rng(c).poisson(lam * 4, 10 ** 6) / 4, 1.0))
            assert abs(vals.mean() - clipped_mean) < 0.02, (c, lam)


# ---------------------------------------------------------------------------
# the native stage
def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s + (3,), dtype=np.uint8)
            for s in [(32, 32), (40, 36), (27, 33), (64, 48), (17, 19)]]


def test_native_equals_the_jax_build():
    """The port's copy of loader.cpp, built by g++ with the JAX package's
    flags: every float batch and every uint8 resize equal to JAX's."""
    assert native.available() and jax_native.available()
    imgs = _images()
    for hw in [(32, 32), (16, 24), (48, 40)]:
        for mean, std in [(0.5, 0.5), (0.0, 1.0)]:
            np.testing.assert_array_equal(
                native.assemble_batch(imgs, hw, mean, std, threads=3),
                jax_native.assemble_batch(imgs, hw, mean, std, threads=2))
        for img in imgs:
            np.testing.assert_array_equal(native.resize_u8(img, hw),
                                          jax_native.resize_u8(img, hw))


def test_native_matches_its_own_plan_in_numpy():
    """Within 1e-5 of the loader's sampling plan and passes in numpy (the
    compiled code may contract into FMAs); the uint8 batch is the resize of
    each image."""
    imgs = _images(1)
    for hw in [(32, 32), (16, 24), (48, 40)]:
        for mean, std in [(0.5, 0.5), (0.0, 1.0)]:
            got = native.assemble_batch(imgs, hw, mean, std)
            np.testing.assert_allclose(
                got, native.assemble_batch_plain(imgs, hw, mean, std),
                rtol=0, atol=1e-5)
        u8 = native.assemble_batch_u8(imgs, hw, threads=4)
        assert u8.dtype == np.uint8 and u8.shape == (5,) + hw + (3,)
        for i, img in enumerate(imgs):
            np.testing.assert_array_equal(u8[i], native.resize_u8(img, hw))
    with pytest.raises(ValueError):
        native.assemble_batch_u8([np.zeros((4, 4), np.uint8)], (2, 2))
    with pytest.raises(ValueError):
        native.assemble_batch([imgs[0], np.zeros((4, 4, 1), np.uint8)],
                              (8, 8))


def test_native_u8_batch_within_one_step_of_the_jax_float_batch():
    """A difference kept by design: the port's on-the-fly path carries the
    natively resized batch as uint8 (the card normalises it), JAX carries
    it as float, so the port's ``u8/255·2 − 1`` is JAX's value rounded to
    the nearest count: within 1/255 (half a count in [-1, 1]), plus float
    rounding of 1e-6."""
    imgs = _images(2)
    for hw in [(32, 32), (48, 40)]:
        u8 = native.assemble_batch_u8(imgs, hw)
        ref = jax_native.assemble_batch(imgs, hw, 0.5, 0.5)
        gap = np.abs(u8.astype(np.float32) / 255.0 * 2.0 - 1.0 - ref)
        assert gap.max() <= 1 / 255 + 1e-6
        assert gap.max() > 0.5 / 255  # not equal: rounded to counts


def test_native_within_pillow_bounds():
    """The C++ bicubic against the Pillow-exact python path: mean |Δ| < 2
    counts and max ≤ 30 (the bounds of ``tests/test_native.py:31-41``)."""
    for img in _images(3):
        for hw in [(32, 32), (16, 20), (70, 50)]:
            got = native.resize_u8(img, hw).astype(int)
            want = imageio.resize_u8(img, (hw[1], hw[0])).astype(int)
            assert np.abs(got - want).mean() < 2.0
            assert np.abs(got - want).max() <= 30


def test_pipeline_native_clean_batches(tree):
    """The on-the-fly path's native stage: uint8 batches, each image the
    native resize of the raw file, in the python path's order; against the
    JAX native pipeline's float batches within 1/255 (above)."""
    port_ds = datasets.CleanImageDataset(tree["clean"], image_size=(32, 32))
    jax_ds = jax_datasets.CleanImageDataset(tree["clean"], (32, 32),
                                            normalize=True)
    pipe = DataPipeline(port_ds, 4, seed=5, device="cpu", use_native=True)
    ref = JaxPipeline(jax_ds, 4, seed=5, use_native=True)
    python = DataPipeline(port_ds, 4, seed=5, device="cpu", use_native=False)
    assert pipe.use_native and not python.use_native
    order = np.random.default_rng(5).permutation(len(port_ds))
    n = 0
    for got, want, slow in zip(pipe, ref, python):
        assert got.dtype == torch.uint8 and got.shape == (4, 32, 32, 3)
        want = np.asarray(want)
        gap = np.abs(got.numpy() / 255.0 * 2.0 - 1.0 - want)
        assert gap.max() <= 1 / 255 + 1e-6
        # a corrupt file is skipped and the batch topped up, in every path
        raws = [r for r in (port_ds.raw(int(i))
                            for i in order[n * 4:n * 4 + 4]) if r is not None]
        raws += raws[:4 - len(raws)]
        for k, raw in enumerate(raws):
            np.testing.assert_array_equal(got[k].numpy(),
                                          native.resize_u8(raw, (32, 32)))
            d = np.abs(got[k].numpy().astype(int) - slow[k].numpy())
            assert d.mean() < 2.0 and d.max() <= 30
        n += 1
    assert n == len(pipe) == 2


def test_pipeline_native_paired_batches(tree):
    """The paired datasets' float sides: equal to the JAX native pipeline's
    batches and within 1e-5 of the numpy plan."""
    kw = dict(noisy_size=(16, 16), clean_size=(32, 32), normalize=True)
    port_ds = datasets.PairedImageDataset(tree["lr"], tree["clean"], **kw)
    jax_ds = jax_datasets.PairedImageDataset(tree["lr"], tree["clean"],
                                             **kw)
    pipe = DataPipeline(port_ds, 8, seed=1, device="cpu", num_threads=3,
                        use_native=True)
    ref = JaxPipeline(jax_ds, 8, seed=1, use_native=True)
    order = [int(i) for i in np.random.default_rng(1).permutation(
        len(port_ds))]
    batches = 0
    for (noisy, clean), (jn, jc) in zip(pipe, ref):
        np.testing.assert_array_equal(noisy.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(clean.numpy(), np.asarray(jc))
        raws = [port_ds.raw(i) for i in order[batches * 8:batches * 8 + 8]]
        np.testing.assert_allclose(
            noisy.numpy(), native.assemble_batch_plain(
                [r[0] for r in raws], (16, 16), 0.5, 0.5), rtol=0, atol=1e-5)
        batches += 1
    assert batches == len(pipe) == 6


def test_pipeline_native_refusals(tree, monkeypatch, caplog):
    """``use_native=True`` refuses before the first batch: a dataset with no
    spec (ValueError), a library that does not build (RuntimeError, the
    compiler's failure in it); auto then takes the python path and says
    so."""
    ds = datasets.CleanImageDataset(tree["clean"], image_size=(32, 32))
    with pytest.raises(ValueError, match="raw_batch_spec"):
        DataPipeline(datasets.CleanImageDataset(tree["clean"], None), 2,
                     device="cpu", use_native=True)
    monkeypatch.setenv("CXX", "false")
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            native.load(rebuild=True)
        with pytest.raises(RuntimeError, match="use_native=True"):
            DataPipeline(ds, 2, device="cpu", use_native=True)
        with caplog.at_level("INFO"):
            auto = DataPipeline(ds, 2, device="cpu")
        assert not auto.use_native and "batch assembly: python" in caplog.text
    finally:
        monkeypatch.delenv("CXX")
        native.load(rebuild=True)
    assert DataPipeline(ds, 2, device="cpu").use_native


# ---------------------------------------------------------------------------
# celeba, synthetic
def test_prepare_clean_dataset_matches_jax(tmp_path):
    raw = tmp_path / "raw"
    rng = np.random.default_rng(6)
    (raw / "alice").mkdir(parents=True)
    imageio.imwrite(str(raw / "alice" / "face.png"),
                    rng.integers(0, 256, (218, 178, 3), np.uint8))
    Image.fromarray(rng.integers(0, 256, (60, 90, 3), np.uint8)).save(
        raw / "alice" / "face.jpg")
    imageio.imwrite(str(raw / "flat.png"),
                    rng.integers(0, 256, (40, 40, 3), np.uint8))
    (raw / "alice" / "bad.png").write_bytes(b"junk")
    for pkg, out in ((celeba, "p"), (jax_celeba, "j")):
        assert pkg.prepare_clean_dataset(str(raw), str(tmp_path / out),
                                         (32, 24)) == 3
    rels = _rels(str(tmp_path / "p"))
    assert rels == _rels(str(tmp_path / "j")) == [
        "alice/face.png", "alice/face_1.png", "person0/flat.png"]
    for rel in rels:
        got = imageio.imread_rgb(str(tmp_path / "p" / rel))
        assert got.shape == (32, 24, 3)
        np.testing.assert_array_equal(
            got, imageio.imread_rgb(str(tmp_path / "j" / rel)))
    img = rng.integers(0, 256, (218, 178, 3), np.uint8)
    np.testing.assert_array_equal(celeba.center_face_crop(img),
                                  jax_celeba.center_face_crop(img))
    # ``limit`` counts files, not crops: the first two are bad.png, skipped,
    # and face.jpg
    for pkg, out in ((celeba, "pl"), (jax_celeba, "jl")):
        assert pkg.prepare_clean_dataset(str(raw), str(tmp_path / out),
                                         limit=2) == 1


def test_heldout_noisy_batch_statistics():
    """The held-out probe's recipe (another generator than JAX's, whose own
    batch takes ~10 s of compiles here): (8, 48, 48, 3) on [0, 1] or its
    [-1, 1] form; per σ part, the noise (the batch minus its clean
    synthetics, regenerated from their seeds) has σ within 10% of the
    recipe's and mean about 0 two σ away from the clip; the
    images differ from the calibration batch's."""
    got = synthetic.heldout_noisy_batch(False)
    assert tuple(got.shape) == (8, 48, 48, 3)
    assert got.min() >= 0 and got.max() <= 1
    assert 0.25 < float(got.mean()) < 0.75
    tanh = synthetic.heldout_noisy_batch(True)
    torch.testing.assert_close(tanh, got * 2 - 1, rtol=0, atol=1e-6)
    assert torch.equal(synthetic.heldout_noisy_batch(False), got)
    for i, sigma in enumerate((0.08, 0.18)):
        clean = synthetic.synth_clean_batch(
            torch.Generator().manual_seed(1000 + i), 4, 48)
        noise = got[4 * i:4 * i + 4] - clean
        inside = (clean > 2 * sigma) & (clean < 1 - 2 * sigma)
        assert abs(float(noise[inside].std()) - sigma) < 0.1 * sigma
        assert abs(float(noise[inside].mean())) < 0.01
    calib = synthetic.calibration_batch(False, size=48)
    assert not torch.equal(calib[:4], got[:4])


# ---------------------------------------------------------------------------
# cli.train on disk pairs and on a cache
@pytest.mark.parametrize("mode", ["pairs", "cache"])
def test_cli_train_on_pairs_and_caches_with_resume(tree, tmp_path, mode):
    """One epoch, then a resumed second one; no noise kernel call on
    either path (the pairs carry their noise)."""
    if mode == "pairs":
        argv = ["--model", "denoise", "--clean-dir", tree["clean"],
                "--noisy-dir", tree["v1"][1], "--no-on-the-fly"]
        steps = 13  # 65 pairs, 52 to train, batch 4
    else:
        cache = str(tmp_path / "cache")
        caching.build_tensor_cache(os.path.join(tree["v1"][1], "speckle"),
                                   tree["clean"], cache, image_size=(16, 16))
        argv = ["--model", "esrgan", "--tensor-cache", cache]
        steps = 3  # 13 pairs, batch 4
    argv += ["--image-size", "16", "16", "--batch-size", "4",
             "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu",
             "--compute-dtype", "float32"]
    calls = []
    with mock.patch.object(noise_kernel, "noise_batch",
                           lambda *a, **k: calls.append(a)), \
            mock.patch.object(noise_kernel, "blind_noise_batch",
                              lambda *a, **k: calls.append(a)):
        tr = cli_train.run(argv + ["--num-epochs", "1"])
        assert tr.steps == steps
        assert np.isfinite(tr.metric_history["g_loss"]).all()
        again = cli_train.build_trainer(cli_train.build_parser().parse_args(
            argv + ["--num-epochs", "2", "--resume"]))
        assert again.start_epoch == 1 and again.opt[0].step == steps
        for (k, v), w in zip(tr.generator.state_dict().items(),
                             again.generator.state_dict().values()):
            # BatchNorm's step counter is not in the checkpoint
            assert k.endswith("num_batches_tracked") or torch.equal(v, w), k
        again.train()
        assert again.steps == steps
        assert len(again.metric_history["psnr"]) == 2
    assert calls == []
    path = port_ckpt.latest_checkpoint(str(tmp_path / "ck"),
                                       f"{argv[1]}_")
    assert port_ckpt.load_checkpoint(path)[1]["epoch"] == 1


def test_srgan_pairs_read_their_lr_side(tree):
    """srgan's disk pairs: LR noisy at image-size // sr-scale, HR clean,
    [-1, 1] (the JAX CLI's ``PairedImageDataset`` at :245-257, built here
    directly: its main would load the VGG tower); esrgan's on [0, 1]: the
    JAX CLI's dataset item for item."""
    base = ["--clean-dir", tree["clean"], "--no-on-the-fly",
            "--image-size", "32", "32"]
    got = _port_dataset(base + ["--model", "srgan", "--sr-scale", "2",
                                "--noisy-dir", tree["lr"]])
    ref = jax_datasets.PairedImageDataset(
        tree["lr"], tree["clean"], TYPES, noisy_size=(16, 16),
        clean_size=(32, 32), normalize=True)
    argv = base + ["--model", "esrgan", "--noisy-dir", tree["v1"][0]]
    for (got, ref), lo in (((got, ref), -1), ((_port_dataset(argv),
                                               _jax_dataset(argv)), 0)):
        assert got.image_pairs == ref.image_pairs
        for i in (0, len(got) - 1):
            for a, b in zip(got[i], ref[i]):
                np.testing.assert_array_equal(a, b)
        assert (got[0][0].min() < 0) == (lo < 0)
    assert got[0][0].shape == (32, 32, 3)
    assert _port_dataset(base + ["--model", "srgan", "--sr-scale", "2",
                                 "--noisy-dir", tree["lr"]])[0][0].shape == \
        (16, 16, 3)
