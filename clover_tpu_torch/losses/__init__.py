from clover_tpu_torch.losses.classification import (  # noqa: F401
    bce_with_logits,
    cross_entropy,
    label_smoothing_cross_entropy,
    masked_lm_cross_entropy,
    masked_lm_focal_loss,
    softmax_focal_multiclass,
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
    qa_loss,
    retrieval_loss,
    total_loss,
)
