from clover_tpu_torch.losses.contrastive import (  # noqa: F401
    cos_norm,
    norm_softmax_loss,
    sim_matrix,
)
from clover_tpu_torch.losses.objectives import retrieval_loss, total_loss  # noqa: F401
