from daliid_tpu_torch.eval.features import FeatureExtractor, extract_features
from daliid_tpu_torch.eval.fusion import (
    average_distmats,
    concat_features_distmat,
    magnitude_weighted_distmat,
    magnitude_weights,
)
from daliid_tpu_torch.eval.matcher import GalleryIndex, serving_embedding
from daliid_tpu_torch.eval.rerank import re_ranking, rerank_shortlists
from daliid_tpu_torch.eval.validate import (
    BriarValidator,
    Validator,
    get_validator,
    msmt17_balanced_accuracy,
)

__all__ = [
    "FeatureExtractor",
    "extract_features",
    "GalleryIndex",
    "serving_embedding",
    "re_ranking",
    "rerank_shortlists",
    "BriarValidator",
    "Validator",
    "get_validator",
    "msmt17_balanced_accuracy",
    "concat_features_distmat",
    "average_distmats",
    "magnitude_weights",
    "magnitude_weighted_distmat",
]
