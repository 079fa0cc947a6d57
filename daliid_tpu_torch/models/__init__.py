from daliid_tpu_torch.models.densenet import DenseNet121ReID
from daliid_tpu_torch.models.efficientnet import EfficientNetB0ReID
from daliid_tpu_torch.models.factory import (
    MODEL_REGISTRY,
    ModelBundle,
    build_ensembles,
    build_model_pair,
    get_model,
)
from daliid_tpu_torch.models.inception import InceptionV3ReID
from daliid_tpu_torch.models.osnet import OSNetReID
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.models.transreid_jpm import TransReIDJPM
from daliid_tpu_torch.models.vit import ViTReID

__all__ = ["MODEL_REGISTRY", "ModelBundle", "build_ensembles", "build_model_pair", "get_model",
           "DenseNet121ReID", "EfficientNetB0ReID", "InceptionV3ReID", "OSNetReID",
           "ResNet50ReID", "TransReIDJPM", "ViTReID"]
