from daliid_tpu_torch.train.proxies import mine_proxies_and_centers, select_proxies_farthest_point
from daliid_tpu_torch.train.sampler import PKBatch, PKBatchSampler
from daliid_tpu_torch.train.trainer import Trainer, lr_schedule_values, microbatch_slots

__all__ = [
    "PKBatch",
    "PKBatchSampler",
    "Trainer",
    "lr_schedule_values",
    "microbatch_slots",
    "mine_proxies_and_centers",
    "select_proxies_farthest_point",
]
