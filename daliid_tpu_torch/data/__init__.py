from daliid_tpu_torch.data.registry import (
    ReidTable,
    data_root,
    load_dataset,
    merge_train_tables,
    parse_market_duke_dir,
    register_dataset,
)
from daliid_tpu_torch.data.synthetic import make_synthetic_dataset
from daliid_tpu_torch.data.turbulence import turbulence_path

__all__ = [
    "ReidTable",
    "data_root",
    "load_dataset",
    "merge_train_tables",
    "parse_market_duke_dir",
    "register_dataset",
    "make_synthetic_dataset",
    "turbulence_path",
]
