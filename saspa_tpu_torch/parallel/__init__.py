from saspa_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    init_distributed,
    local_device_count,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
