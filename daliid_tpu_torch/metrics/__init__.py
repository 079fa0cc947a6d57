from daliid_tpu_torch.metrics.ranking import (
    cosine_distance_matrix,
    evaluate_rank,
    evaluate_rank_numpy,
    max_positives_bound,
    positive_columns,
)

__all__ = [
    "cosine_distance_matrix",
    "evaluate_rank",
    "evaluate_rank_numpy",
    "max_positives_bound",
    "positive_columns",
]
