"""The rank functions of the port's process-group tests, in a module that
imports no JAX: ``torch.multiprocessing.spawn``'s children import the
module that defines their target.

``spawn(case, world, tmp_path, *args)`` runs ``case(rank, world, *args)``
on ``world`` gloo ranks initialised through a file under ``tmp_path`` (no
port, so test workers never collide) and returns each rank's result, a
dict of tensors and numbers, in rank order; ``start`` returns at once, with
a function that waits for them.  Each rank runs PyTorch on one
thread.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.parallel import collectives
from celebrity_image_denoiser_tpu_torch.parallel.mesh import (
    process_mesh,
    shard_index,
)
from celebrity_image_denoiser_tpu_torch.train import gan_trainer

LR = 1e-4


def _entry(rank, world, init, case, args, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = globals()[case](rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def start(case, world, tmp_path, *args):
    """Start ``spawn``'s ranks and return ``wait()``, which joins them and
    returns their results: the caller works while they run."""
    out = tmp_path / f"{case}_{world}"
    out.mkdir()
    ctx = mp.spawn(_entry, args=(world, f"file://{out}/pg", case, args,
                                 str(out)), nprocs=world, join=False)

    def wait():
        while not ctx.join():
            pass
        results = []
        for r in range(world):
            with open(out / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


def spawn(case, world, tmp_path, *args):
    return start(case, world, tmp_path, *args)()


# ---------------------------------------------------------------------------
def collectives_case(rank, world):
    """psum, psum_mean, all_gather and ppermute_shift (±1, wrapping and
    not) of ``rank + 1`` filled tensors, and psum's backward."""
    x = torch.full((2, 3), float(rank + 1))
    out = {"psum": collectives.psum(x), "mean": collectives.psum_mean(x),
           "gather": collectives.all_gather(x[:1]),
           "stack": collectives.all_gather(x[:1], tiled=False)}
    for shift in (1, -1, 2):
        for wrap in (False, True):
            out[f"shift{shift}_{wrap}"] = collectives.ppermute_shift(
                x, None, shift, wrap)
    w = torch.full((3,), float(rank + 1), requires_grad=True)
    # d/dw_r of sum_r' (r'+1)·sum(psum(w)) = sum_r' (r'+1) on every rank
    loss = (rank + 1) * collectives.psum(w).sum()
    out["grad"] = torch.autograd.grad(loss, w)[0]
    return out


def _models(family, weights):
    if family == "dncnn":
        g, d = registry.build_generator("dncnn", depth=5), None
    else:
        g = registry.build_generator(family)
        d = registry.build_discriminator(family)
    g.load_state_dict(weights["g"])
    if d is not None:
        d.load_state_dict(weights["d"])
    return g, d


def _state(g, d, opt, out):
    return {"g": {k: v.clone() for k, v in g.state_dict().items()},
            "d": {} if d is None else {k: v.clone()
                                       for k, v in d.state_dict().items()},
            "g_mu": {k: v.clone() for k, v in opt[0].mu.items()},
            "d_mu": {k: v.clone() for k, v in opt[1].mu.items()},
            "metrics": {k: float(v) for k, v in out.items()
                        if k != "noise_kinds"}}


def dp_step_case(rank, world, specs, mesh_shape=None):
    """Per family of ``specs`` (family → (weights, noisy, clean,
    clean_u8)): one f32 step over a mesh of ``world`` ranks (of
    ``mesh_shape`` and ``("replica", "data")`` when given) on this rank's
    share of the global (noisy, clean) batch, then one on-the-fly step from
    the same weights on its share of ``clean_u8``."""
    mesh = (process_mesh() if mesh_shape is None else
            process_mesh(mesh_shape, ("replica", "data")))
    share = shard_index(mesh)
    out = {}
    for family, (weights, noisy, clean, clean_u8) in specs.items():
        res = {}
        for name, fly in (("pair", False), ("fly", True)):
            g, d = _models(family, weights)
            init_fn, step_fn = gan_trainer.make_train_step(
                g, d, family=family, mesh=mesh, on_the_fly_noise=fly)
            opt = init_fn()
            batch = clean_u8 if fly else clean
            n = batch.shape[0] // world
            rows = slice(share * n, (share + 1) * n)
            gen = torch.Generator().manual_seed(7)
            m = step_fn(opt, None if fly else torch.from_numpy(noisy[rows]),
                        torch.from_numpy(batch[rows]), gen, LR, LR)
            res[name] = _state(g, d, opt, m)
        out[family] = res
    return out


def two_rank_case(rank, world, specs, argv):
    """``dp_step_case`` and ``cli_case`` in one spawn."""
    return {"dp": dp_step_case(rank, world, specs),
            "cli": cli_case(rank, world, argv)}


def four_rank_case(rank, world, specs):
    """The collectives, then the denoise step of ``specs`` over a 1-D mesh
    of the 4 ranks and over a ``(2, 2)`` ``("replica", "data")`` mesh."""
    return {"collectives": collectives_case(rank, world),
            "1d": dp_step_case(rank, world, specs),
            "2d": dp_step_case(rank, world, specs, (2, 2))}


def single_step(specs):
    """``dp_step_case``'s steps in this process, without a mesh, on the
    whole batches."""
    out = {}
    for family, (weights, noisy, clean, clean_u8) in specs.items():
        res = {}
        for name, fly in (("pair", False), ("fly", True)):
            g, d = _models(family, weights)
            init_fn, step_fn = gan_trainer.make_train_step(
                g, d, family=family, on_the_fly_noise=fly)
            opt = init_fn()
            gen = torch.Generator().manual_seed(7)
            m = step_fn(opt, None if fly else torch.from_numpy(noisy),
                        torch.from_numpy(clean_u8 if fly else clean), gen,
                        LR, LR)
            res[name] = _state(g, d, opt, m)
        out[family] = res
    return out


def cli_case(rank, world, argv):
    """``cli.train.run(argv)`` on this rank, inside the process group the
    spawn made (the CLI takes an initialised group as a launcher's), with
    the checkpoint writes counted; then ``--no-data-parallel``, which a
    world of more than one refuses."""
    from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train

    writes = []
    save = checkpoint.save_checkpoint

    def counted(path, *a, **k):
        writes.append(path)
        return save(path, *a, **k)

    checkpoint.save_checkpoint = counted
    try:
        tr = cli_train.run(argv)
    finally:
        checkpoint.save_checkpoint = save
    try:
        cli_train.run(argv + ["--no-data-parallel"])
        refused = None
    except SystemExit as e:
        refused = str(e)
    return {"history": tr.metric_history, "rank": tr.rank,
            "writes": writes, "steps": tr.steps, "refused": refused,
            "g": {k: v.clone() for k, v in tr.generator.state_dict().items()}}


def random_weights(family, seed=0):
    """Seeded weights of ``family``'s test models, running statistics
    perturbed (a statistic carried the wrong way shows)."""
    torch.manual_seed(seed)
    g, d = _models_fresh(family)
    out = {}
    for key, m in (("g", g), ("d", d)):
        if m is None:
            continue
        for name, buf in m.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.1, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
        out[key] = {k: v.clone() for k, v in m.state_dict().items()}
    return out


def _models_fresh(family):
    if family == "dncnn":
        return registry.build_generator("dncnn", depth=5), None
    return (registry.build_generator(family),
            registry.build_discriminator(family))


def batch(family, n, hw, seed=0):
    """(noisy, clean) float32 in ``family``'s domain ([0, 1] for dncnn,
    [-1, 1] else) and a uint8 clean batch."""
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0, 1, (n, hw, hw, 3))
    noisy = np.clip(clean + rng.normal(0, 0.1, clean.shape), 0, 1)
    if family != "dncnn":
        noisy, clean = noisy * 2 - 1, clean * 2 - 1
    u8 = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    return noisy.astype(np.float32), clean.astype(np.float32), u8


def specs(families, n, hw):
    """family → (weights, noisy, clean, clean_u8) for ``dp_step_case``."""
    return {f: (random_weights(f, seed=i), *batch(f, n, hw, seed=i))
            for i, f in enumerate(families)}
