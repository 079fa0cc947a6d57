from daliid_tpu_torch.data.registry import (
    ReidTable,
    data_root,
    load_dataset,
    parse_market_duke_dir,
    register_dataset,
)
from daliid_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = [
    "ReidTable",
    "data_root",
    "load_dataset",
    "parse_market_duke_dir",
    "register_dataset",
    "make_synthetic_dataset",
]
