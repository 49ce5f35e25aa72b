from vmrframe_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_grads,
    all_reduce_sum,
    gather_outputs,
    initialize_distributed,
    is_distributed,
    local_batch_slice,
    rank,
    shard_batch,
    world,
)
