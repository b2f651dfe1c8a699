from saspa_tpu_torch.parallel.head import ColumnParallelDense, shard_head
from saspa_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_group,
    init_distributed,
    local_device_count,
    make_mesh,
    model_group,
    pad_to_multiple,
    replicated,
    shard_batch,
)
