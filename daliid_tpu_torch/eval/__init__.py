from daliid_tpu_torch.eval.features import FeatureExtractor, extract_features
from daliid_tpu_torch.eval.matcher import GalleryIndex, serving_embedding
from daliid_tpu_torch.eval.validate import BriarValidator, Validator, get_validator

__all__ = [
    "FeatureExtractor",
    "extract_features",
    "GalleryIndex",
    "serving_embedding",
    "BriarValidator",
    "Validator",
    "get_validator",
]
