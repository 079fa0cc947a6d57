"""daliid_tpu_torch — the PyTorch/CUDA port of ``daliid_tpu``.

The port trains, serves and evaluates ResNet-50 ReID on an NVIDIA H100: the
training loop (``cli/train.py``, turbulence-paired PK batches, center and
proxy losses, Adam, the EMA momentum model, per-epoch proxy mining), the
identification daemon (``cli/serve.py``), the one-shot search CLI
(``cli/search.py``) and single-model evaluation (``cli/evaluate.py``). Its
layout mirrors ``daliid_tpu`` module for module. It imports nothing of
``daliid_tpu`` and no JAX: what it needs from there is copied.

The three kernels the JAX package wrote in Pallas on these paths are
hand-written CUDA for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first
use: ``ops/fused_augment.py`` (train augmentation), ``ops/search_topk.py``
(gallery search) and ``ops/rank_counts.py`` (ranking counts). Entry points
run on the GPU unless the caller passes ``--device cpu`` (see
:mod:`daliid_tpu_torch.device`).
"""

__version__ = "0.2.0"
