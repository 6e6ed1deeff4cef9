from clover_tpu_torch.losses.classification import (  # noqa: F401
    masked_lm_cross_entropy,
    masked_lm_focal_loss,
)
from clover_tpu_torch.losses.contrastive import (  # noqa: F401
    cos_norm,
    exclusive_nce_with_ranking,
    margin_ranking_loss,
    norm_softmax_loss,
    sim_matrix,
)
from clover_tpu_torch.losses.objectives import (  # noqa: F401
    PretrainLossConfig,
    pretrain_losses,
    retrieval_loss,
    total_loss,
)
