"""The device mesh: DP and TP over a ``torch.distributed`` world, one
process a device (``parallel/mesh.py``)."""

from rau_vqa_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_pspec,
    init_distributed,
    make_mesh,
    make_sharded_predict,
    make_sharded_pixels_predict,
    make_sharded_train_step,
    param_pspecs,
    shard_batch,
    state_shardings,
)
