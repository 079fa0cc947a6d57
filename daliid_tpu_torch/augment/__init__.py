from daliid_tpu_torch.augment.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    decode_resize,
    normalize_images,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "decode_resize", "normalize_images"]
