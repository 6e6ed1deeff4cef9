from clover_tpu_torch.evaluation.metrics import (  # noqa: F401
    itm_t2v_recall,
    mean_average_precision,
    mean_class_accuracy,
    multiple_choice_retrieval_acc,
    precision_recall_at_threshold,
    qa_accuracy,
    retrieval_recall,
    retrieval_recall_varied,
    top_k_accuracy,
    zeroshot_action_recognition_acc,
)
