from daliid_tpu_torch.metrics.ranking import (
    cosine_distance_matrix,
    evaluate_rank,
    evaluate_rank_numpy,
    evaluate_rank_sharded,
    evaluate_rank_sharded_multihead,
    max_positives_bound,
    positive_columns,
    queried_positives_bound,
)

__all__ = [
    "cosine_distance_matrix",
    "evaluate_rank",
    "evaluate_rank_numpy",
    "evaluate_rank_sharded",
    "evaluate_rank_sharded_multihead",
    "max_positives_bound",
    "positive_columns",
    "queried_positives_bound",
]
