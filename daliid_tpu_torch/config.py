"""One typed training configuration: model, data, sampler, losses, schedule,
eval.

Copy of ``daliid_tpu/config.py::TrainConfig`` (the reference's
``mainKIT.py:316-344`` flags), plus ``device``. The field of a feature that
is not ported yet (remat) is left out; ``cli/train.py`` rejects its flag.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    # model
    model_name: str = "resnet50"
    img_height: int = 256                 # mainKIT.py:320
    img_width: int = 128                  # mainKIT.py:321
    compute_dtype: str = "bfloat16"
    model_path: Optional[str] = None      # pretrained weights (.npz or torch)
    num_classes: int = 0                  # classifier head for JPM; -1 = #train ids
    id_loss_type: str = "softmax"         # cfg.MODEL.ID_LOSS_TYPE (make_models.py:260-277)
    margin_s: Optional[float] = None      # cfg.SOLVER.COSINE_SCALE (None: per-head default)
    margin_m: Optional[float] = None      # cfg.SOLVER.COSINE_MARGIN
    sie_cameras: int = 0                  # SIE table size; -1 = one per training camera
    sie_coef: float = 1.5                 # SIE scale (sie_xishu)

    # data
    dataset: str = "Market"
    data_root: Optional[str] = None
    turbulence_dir: Optional[str] = None  # mainKIT.py:336
    kind_of_transform: int = 1            # 1 = AT-paired, 0 = clean (mainKIT.py:340)
    is_clean_training: bool = False       # mainKIT.py:337

    # sampler
    P: int = 16                           # mainKIT.py:326
    K: int = 12                           # mainKIT.py:327

    # optimization (mainKIT.py:324-332 defaults)
    lr: float = 3.5e-4
    weight_decay: float = 5e-4
    tau: float = 0.05
    beta: float = 0.999
    lambda_proxy: float = 0.4
    num_epochs: int = 250
    num_proxies: int = 5                  # train_encodersKIT.py:61
    seed: int = 12                        # mainKIT.py:48-50

    # eval / checkpointing
    eval_freq: int = 5                    # mainKIT.py:344 (no default upstream)
    ckpt_freq: int = 1                    # crash-resume checkpoint (full state
                                          # + RNG) every N epochs under
                                          # save_dir/latest; 0 disables
    save_dir: str = "checkpoints"
    metrics_dir: str = "metrics"
    version: str = "v0"

    # runtime
    extractor_batch: int = 512
    mining_quantize: Optional[str] = None  # int8 PTQ of the per-epoch mining re-embedding
    mining_calib_batches: int = 1
    decode_workers: int = 16
    grad_accum: int = 1                   # microbatches per optimizer step
    device: str = "cuda"

    @property
    def img_size(self) -> Tuple[int, int]:
        return (self.img_height, self.img_width)
