from daliid_tpu_torch.models.factory import (
    MODEL_REGISTRY,
    ModelBundle,
    build_model_pair,
    get_model,
)
from daliid_tpu_torch.models.resnet import ResNet50ReID

__all__ = ["MODEL_REGISTRY", "ModelBundle", "build_model_pair", "get_model", "ResNet50ReID"]
