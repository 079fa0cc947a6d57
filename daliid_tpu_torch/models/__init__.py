from daliid_tpu_torch.models.factory import MODEL_REGISTRY, ModelBundle, get_model
from daliid_tpu_torch.models.resnet import ResNet50ReID

__all__ = ["MODEL_REGISTRY", "ModelBundle", "get_model", "ResNet50ReID"]
