"""Turbulence-companion path resolution.

Copy of ``daliid_tpu/data/turbulence.py`` (``:15-30``).

The reference pairs every clean image with a pre-rendered atmospheric-
turbulence copy named ``<stem>_turbstrength{1..5}.jpg`` in a separate
directory at ``Person-ReID/train_encodersKIT.py:365-377`` (training) and
``Person-ReID/getFeatures.py:25-35`` (distorted-gallery eval). MSMT17's
copies carry the identity's directory name as a prefix,
``<pid>_<stem>_turbstrength{s}.jpg``.
"""

from __future__ import annotations

import os


def turbulence_path(image_path: str, turbulence_dir: str, strength: int,
                    dataset: str | None = None) -> str:
    """Path of the pre-rendered turbulence copy of ``image_path`` at the
    given strength (1-5); ``dataset="MSMT17"`` selects its pid-prefixed
    names."""
    stem = os.path.basename(image_path)
    stem = stem[: stem.rfind(".")] if "." in stem else stem
    if dataset == "MSMT17":
        name = f"{stem.split('_')[0]}_{stem}_turbstrength{strength}.jpg"
    else:
        name = f"{stem}_turbstrength{strength}.jpg"
    return os.path.join(turbulence_dir, name)
