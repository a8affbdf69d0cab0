"""The port's training mesh — data parallelism over a ``torch.distributed``
process group (``make_train_step(mesh=)``, ``parallel/collectives.py``, the
synced BatchNorm, K4's first sample, ``cli.train`` under a process group,
``dryrun_multichip``) — on gloo ranks on the CPU, against the JAX package's
mesh step.

The ranks run in spawned processes (``tests/torch_port_dp_ranks.py``,
which imports no JAX), initialised through a file under ``tmp_path``.

* A 2-rank f32 step of denoise (D has BatchNorm) and dncnn (G has
  BatchNorm, depth 5) at batch 8, 16²: the losses (rtol 1e-4), the updated
  parameters and BatchNorm running statistics (rtol 1e-4, atol 1e-6, as
  ``tests/test_parallel.py`` holds JAX's mesh step) and each optimiser's
  first moment, the gradient (1e-4 of each leaf's largest), against JAX's
  mesh step over 2 virtual devices and against the port's single-process
  step.  Adam's first step moves a weight by lr·g/(|g| + ε): where |g| is
  below 100·ε (a bias feeding a train-mode BatchNorm, whose gradient is
  exactly 0 and held as rounding on each side, and a few other weights)
  the step turns on g's last digits, so those weights are held within
  2·lr; their gradients are held by the first moments.  D's third
  forward, after its update, takes the batch mean of a conv whose bias is
  such a weight: a running mean after it is held within 0.1 (the
  momentum) × that bias's difference more.  The
  on-the-fly step (K4 at each rank's first sample, the blind σ for dncnn)
  equals the single-process on-the-fly step by the same measures, and both
  ranks hold the same parameters after it.
* On 4 ranks: ``psum``, ``psum_mean``, ``all_gather`` and
  ``ppermute_shift`` (±1 and 2, wrapping and not), psum's backward; and a
  ``("replica", "data")`` step equal to the 1-D step over the same ranks.
* ``cli.train`` on 2 ranks for 2 steps at 32²: one history on both ranks,
  rank 0 alone writes the checkpoint, which loads in the JAX package and
  resumes without a mesh; ``--no-data-parallel`` is refused there.
* ``dryrun_multichip(2)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu import parallel as jax_parallel
from celebrity_image_denoiser_tpu.ckpt import checkpoint as jax_ckpt
from celebrity_image_denoiser_tpu.core import prng
from celebrity_image_denoiser_tpu.train import gan_trainer as jax_trainer
from celebrity_image_denoiser_tpu.utils import tree as jax_tree
from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as port_ckpt
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    synth_clean_batch,
)

import torch_port_dp_ranks as ranks

FAMILIES = ("denoise", "dncnn")
N, HW = 8, 16
LR = ranks.LR
ADAM_EPS = 1e-8  # train/optim.py, as the JAX optimiser's


@pytest.fixture(scope="module")
def specs():
    return ranks.specs(FAMILIES, N, HW)


def _cli_argv(tmp):
    """``cli.train``'s arguments for 2 steps of 4 on 10 PNGs of 32² under
    ``tmp`` (the split keeps 8 for training)."""
    clean = tmp / "clean" / "person"
    clean.mkdir(parents=True)
    imgs = synth_clean_batch(torch.Generator().manual_seed(1), 10, 32)
    for i, im in enumerate((imgs * 255).round().to(torch.uint8).numpy()):
        (clean / f"{i:02d}.png").write_bytes(imageio.encode_png(im))
    return ["--clean-dir", str(tmp / "clean"), "--image-size", "32", "32",
            "--batch-size", "4", "--num-epochs", "1", "--checkpoint-dir",
            str(tmp / "ck"), "--graph-dir", str(tmp / "graphs"), "--device",
            "cpu", "--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def spawned(specs, tmp_path_factory):
    """One spawn of 2 ranks: each family's steps, then ``cli.train``;
    rank 0's and rank 1's results, the CLI's arguments, and JAX's mesh
    steps (family → (carry, metrics)), computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("two")
    argv = _cli_argv(tmp)
    wait = ranks.start("two_rank_case", 2, tmp, specs, argv)
    jax_steps = {f: _jax_mesh_step(f, *specs[f][:3]) for f in FAMILIES}
    return wait(), argv, jax_steps


@pytest.fixture(scope="module")
def two_ranks(spawned):
    return [r["dp"] for r in spawned[0]]


def _jax_mesh_step(family, weights, noisy, clean):
    """JAX's mesh step (``make_train_step(mesh=)``, the batch sharded over
    2 of the virtual devices, as the port's over 2 ranks) from the port's
    weights: (carry, metrics)."""
    if family == "dncnn":
        g, d = jax_models.DnCNN(depth=5), None
    else:
        g, d = jax_models.DenoiseGenerator(), jax_models.DenoiseDiscriminator()
    mods = ranks._models(family, weights)
    trees = []
    for m in mods:
        trees += ([{}, {}] if m is None else
                  list(convert.state_dict_to_jax_params(m.state_dict(),
                                                        module=m)))
    mesh = jax_parallel.make_mesh(devices=jax.devices()[:2])
    init_fn, step = jax_trainer.make_train_step(g, d, family=family,
                                                mesh=mesh, donate=False)
    opt = init_fn(prng.key(2))
    carry = jax.device_put((*trees, opt[4], opt[5]),
                           jax_parallel.replicated(mesh))
    bsh = jax_parallel.batch_sharding(mesh)
    return step(carry, jax.device_put(jnp.asarray(noisy), bsh),
                jax.device_put(jnp.asarray(clean), bsh), prng.key(3), LR, LR)


def _flat(sd, family, which):
    """A port state_dict as flat JAX-named (params, state) trees."""
    m = ranks._models_fresh(family)[0 if which == "g" else 1]
    p, s = convert.state_dict_to_jax_params(sd, module=m)
    return jax_tree.flatten(p), jax_tree.flatten(s)


def _np(tree):
    return {k: np.asarray(v, np.float64) for k, v in
            jax_tree.flatten(tree).items()}


def _assert_step_matches(got, want, what):
    """``got`` and ``want``: (params, state, first moments) flat trees of
    one module (the docstring's bounds)."""
    (gp, gs, gm), (wp, ws, wm) = got, want
    assert set(gp) == set(wp) and set(gs) == set(ws) and set(gm) == set(wm)
    floor = 1e-5 * max(np.abs(v).max() for v in wm.values())
    for k, v in wm.items():
        np.testing.assert_allclose(
            np.asarray(gm[k], np.float64), v,
            atol=max(1e-4 * np.abs(v).max(), floor), rtol=0,
            err_msg=f"{what} mu {k}")
    for k, v in wp.items():
        # |g| below 100 ε: Adam's step lr·g/(|g| + ε) there turns on g's
        # last digits (the first moment is 0.1·g)
        flat = np.abs(wm[k]) < 0.1 * 100 * ADAM_EPS
        tol = np.where(flat, 2 * LR, 1e-6 + 1e-4 * np.abs(v))
        bad = np.abs(np.asarray(gp[k], np.float64) - v) > tol
        assert not bad.any(), (what, "param", k, int(bad.sum()),
                               float(np.abs(np.asarray(gp[k]) - v).max()))
    for k, v in ws.items():
        # D's third forward (after its update) takes the batch mean of a
        # conv whose bias Adam moved by the sign of a rounding: the running
        # mean after it carries momentum 0.1 × that bias's difference
        layer, stat = k.rsplit(".", 1)
        bias = f"{layer.rsplit('.', 1)[0]}.{int(layer.rsplit('.', 1)[1]) - 1}" \
            ".bias" if layer.startswith("model.") else None
        shift = (0.1 * np.abs(np.asarray(gp[bias]) - wp[bias]).max()
                 if stat == "mean" and bias in wp else 0.0)
        np.testing.assert_allclose(np.asarray(gs[k], np.float64), v,
                                   rtol=1e-4, atol=1e-6 + shift,
                                   err_msg=f"{what} state {k}")


def _port_trees(res, family, which):
    p, s = _flat(res[which], family, which)
    mu = convert.state_dict_to_jax_params(
        res[f"{which}_mu"],
        module=ranks._models_fresh(family)[0 if which == "g" else 1])
    return p, s, jax_tree.flatten(mu[0])


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_the_jax_mesh_step(family, spawned,
                                                  two_ranks):
    carry, ref = spawned[2][family]
    got = two_ranks[0][family]["pair"]
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(got["metrics"][k], float(ref[k]),
                                   rtol=1e-4, err_msg=k)
    _assert_step_matches(_port_trees(got, family, "g"),
                         (_np(carry[0]), _np(carry[1]), _np(carry[4].mu)),
                         f"{family} G")
    if family == "denoise":
        _assert_step_matches(_port_trees(got, family, "d"),
                             (_np(carry[2]), _np(carry[3]),
                              _np(carry[5].mu)), f"{family} D")
    else:
        assert got["metrics"]["d_loss"] == 0.0 and not got["d_mu"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["pair", "fly"])
def test_two_rank_step_matches_the_single_process_step(family, kind, specs,
                                                       two_ranks):
    """On pairs, and on the fly: each rank's noise is its rows of the
    global draw, so the step is the single-process one."""
    single = ranks.single_step({family: specs[family]})[family][kind]
    got = two_ranks[0][family][kind]
    for k, v in single["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for which in ("g", "d") if family == "denoise" else ("g",):
        want = _port_trees(single, family, which)
        _assert_step_matches(_port_trees(got, family, which),
                             tuple({k: np.asarray(v, np.float64)
                                    for k, v in t.items()} for t in want),
                             f"{family} {kind} {which}")
    # the ranks took the same step
    other = two_ranks[1][family][kind]
    for k, v in got["g"].items():
        assert torch.equal(v, other["g"][k]), k
    assert got["metrics"] == other["metrics"]


@pytest.fixture(scope="module")
def four_ranks(specs, tmp_path_factory):
    return ranks.spawn("four_rank_case", 4, tmp_path_factory.mktemp("four"),
                       {"denoise": specs["denoise"]})


def test_collectives_on_four_ranks(four_ranks):
    for r, res in enumerate(r["collectives"] for r in four_ranks):
        x = torch.full((2, 3), float(r + 1))
        assert torch.equal(res["psum"], torch.full((2, 3), 10.0))
        assert torch.equal(res["mean"], torch.full((2, 3), 2.5))
        assert torch.equal(res["gather"],
                           torch.arange(1.0, 5.0).view(4, 1).expand(4, 3))
        assert res["stack"].shape == (4, 1, 3)
        for shift in (1, -1, 2):
            src = r - shift
            want = (torch.full_like(x, float(src + 1)) if 0 <= src < 4
                    else torch.zeros_like(x))
            assert torch.equal(res[f"shift{shift}_False"], want), (r, shift)
            assert torch.equal(res[f"shift{shift}_True"],
                               torch.full_like(x, float(src % 4 + 1)))
        # the gradient of Σ_r (r+1)·sum(psum(w)) on each rank: Σ (r+1)
        assert torch.equal(res["grad"], torch.full((3,), 10.0))


def test_replica_data_mesh_step_equals_the_one_axis_step(four_ranks):
    """The ``("replica", "data")`` mesh shares the batch over both axes, as
    JAX's ``P(("replica", "data"))``, and sums over each axis in turn: the
    step of the 1-D mesh over the same 4 ranks, within float rounding."""
    for res in four_ranks:
        for kind in ("pair", "fly"):
            one, two = res["1d"]["denoise"][kind], res["2d"]["denoise"][kind]
            for k, v in one["metrics"].items():
                np.testing.assert_allclose(two["metrics"][k], v, rtol=1e-5,
                                           atol=1e-7)
            for which in ("g", "d"):
                want = _port_trees(one, "denoise", which)
                _assert_step_matches(
                    _port_trees(two, "denoise", which),
                    tuple({k: np.asarray(v, np.float64) for k, v in t.items()}
                          for t in want), f"2-D {kind} {which}")


def test_cli_train_on_two_ranks(spawned):
    res, argv = [r["cli"] for r in spawned[0]], spawned[1]
    ck = argv[argv.index("--checkpoint-dir") + 1]
    assert [r["rank"] for r in res] == [0, 1]
    assert [r["steps"] for r in res] == [2, 2]  # 8 train images / batch 4
    assert res[0]["history"] == res[1]["history"]
    assert np.isfinite(res[0]["history"]["g_loss"]).all()
    assert len(res[0]["writes"]) >= 1 and res[1]["writes"] == []
    for k, v in res[0]["g"].items():
        assert torch.equal(v, res[1]["g"][k]), k
    assert "--no-data-parallel" in res[0]["refused"]
    path = port_ckpt.latest_checkpoint(ck, "denoise_")
    # the JAX package loads it into its own trees
    sections, meta = jax_ckpt.load_checkpoint(path)
    assert meta["family"] == "denoise" and meta["epoch"] == 0
    jp, _ = jax.eval_shape(jax_models.DenoiseGenerator().init, prng.key(0))
    want = {k: np.shape(v) for k, v in jax_tree.flatten(jp).items()}
    got = {k: np.shape(v) for k, v in
           jax_tree.flatten(sections["generator"]).items()}
    assert got == want
    assert int(sections["g_optimizer"]["step"]) == 2
    # and it resumes without a mesh, with rank 0's weights
    tr = cli_train.build_trainer(cli_train.build_parser().parse_args(
        argv + ["--resume", "--num-epochs", "2"]))
    assert tr.mesh is None and tr.start_epoch == 1
    for k, v in tr.generator.state_dict().items():
        assert torch.equal(v, res[0]["g"][k]), k


def test_dryrun_multichip_two():
    from celebrity_image_denoiser_tpu_torch.dryrun import dryrun_multichip

    if not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun_multichip(2)
    res = dryrun_multichip(2, device="cpu")
    assert np.isfinite(res["g_loss"]) and "g2_loss" not in res
    assert res["sharded"] == res["halo"] == [1, 32, 16, 3]
    assert res["backend_float"] == "float"
    assert res["backend_int8"].startswith("int8")
