from daliid_tpu_torch.augment.preprocess import decode_resize, normalize_images

__all__ = ["decode_resize", "normalize_images"]
