"""The data, spatial and tensor axes and the GPipe trunk over ``torch.distributed``."""

from tfcgan_tpu_torch.parallel.distributed import (
    global_mesh_devices,
    initialize,
    local_device,
)
from tfcgan_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    all_gather_batch,
    all_reduce_max,
    all_reduce_mean_,
    all_reduce_min,
    all_reduce_sum,
    local_part,
    local_rows,
    local_share,
    loss_mesh,
    make_mesh,
    place_state,
    replicate,
    shard_batch,
    shard_draws,
)
from tfcgan_tpu_torch.parallel.spatial import (
    Rows,
    SpatialAxis,
    active_rows,
    gather_spatial,
    image_rows,
    split_rows,
)
from tfcgan_tpu_torch.parallel.tensor import (
    TensorAxis,
    full_optimizer_state_dict,
    full_state_dict,
    gathered_copy,
    param_sharding_dim,
    shard_params,
)
from tfcgan_tpu_torch.parallel.pipeline import (
    make_pipe_mesh,
    pipeline_apply,
    resnet_trunk_pipeline,
    stack_stages,
)
