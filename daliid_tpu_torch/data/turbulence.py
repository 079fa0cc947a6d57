"""Turbulence-companion path resolution.

Copy of ``daliid_tpu/data/turbulence.py`` for the datasets the port loads
(Market-1501 and Synthetic).

The reference pairs every clean image with a pre-rendered atmospheric-
turbulence copy named ``<stem>_turbstrength{1..5}.jpg`` in a separate
directory at ``Person-ReID/train_encodersKIT.py:365-377`` (training) and
``Person-ReID/getFeatures.py:25-35`` (distorted-gallery eval). MSMT17's
pid-prefixed names come with the port of its parser.
"""

from __future__ import annotations

import os


def turbulence_path(image_path: str, turbulence_dir: str, strength: int) -> str:
    """Path of the pre-rendered turbulence copy of ``image_path`` at the
    given strength (1-5)."""
    stem = os.path.basename(image_path)
    stem = stem[: stem.rfind(".")] if "." in stem else stem
    return os.path.join(turbulence_dir, f"{stem}_turbstrength{strength}.jpg")
