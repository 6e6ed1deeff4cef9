from clover_tpu_torch.evaluation.metrics import (  # noqa: F401
    retrieval_recall,
    retrieval_recall_varied,
)
