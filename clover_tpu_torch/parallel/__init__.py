from clover_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_rows,
    all_gather_varied,
    all_gather_with_grad,
    all_reduce_grads,
    all_reduce_with_grad,
    pmean_scalar,
    psum_scalar,
)
from clover_tpu_torch.parallel.mesh import (  # noqa: F401
    barrier,
    broadcast_module,
    data_axis_size,
    data_group,
    init_distributed,
    is_primary,
    rank,
    world,
)
