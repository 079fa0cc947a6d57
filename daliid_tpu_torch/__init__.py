"""daliid_tpu_torch — the PyTorch/CUDA port of ``daliid_tpu``.

The port trains, serves and evaluates ResNet-50 ReID and the ViT /
TransReID-JPM family on an NVIDIA H100: the training loop
(``cli/train.py``, turbulence-paired PK batches, center and proxy losses,
Adam, the EMA momentum model, per-epoch proxy mining), the identification
daemon (``cli/serve.py``), the one-shot search CLI
(``cli/search.py``) and single-model evaluation (``cli/evaluate.py``). Its
layout mirrors ``daliid_tpu`` module for module. It imports nothing of
``daliid_tpu`` and no JAX: what it needs from there is copied.

The four kernels the JAX package wrote in Pallas are hand-written CUDA for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use:
``ops/fused_augment.py`` (train augmentation), ``ops/search_topk.py``
(gallery search), ``ops/rank_counts.py`` (ranking counts) and
``ops/flash_attention.py`` (the ViT family's attention, for models built
with ``use_fused_attention=True``). Entry points run on the GPU unless the
caller passes ``--device cpu`` (see :mod:`daliid_tpu_torch.device`).
"""

__version__ = "0.3.0"
