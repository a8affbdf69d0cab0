"""Big inputs and multiple devices: the serving mesh (one process over
several devices: data-parallel batches, spatial sharding, halo tiling) and
the training mesh's process groups and collectives."""

from celebrity_image_denoiser_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    process_mesh,
)
from celebrity_image_denoiser_tpu_torch.parallel import collectives  # noqa: F401
from celebrity_image_denoiser_tpu_torch.parallel.dataparallel import (  # noqa: F401
    data_parallel_apply,
    replicate,
    shard_batch,
)
from celebrity_image_denoiser_tpu_torch.parallel import tiling  # noqa: F401
from celebrity_image_denoiser_tpu_torch.parallel.tiling import (  # noqa: F401
    spatial_sharded_apply,
    tiled_apply,
    tiled_apply_single_device,
)
