from daliid_tpu_torch.data.briar import load_briar_manifests, load_eval_splits
from daliid_tpu_torch.data.registry import (
    ReidTable,
    data_root,
    dataset_statistics,
    load_dataset,
    load_multiple_datasets,
    load_text_dataset,
    merge_train_tables,
    parse_deepchange_list,
    parse_manifest,
    parse_market_duke_dir,
    parse_msmt17_list,
    parse_veri_dir,
    parse_veri_wild_list,
    register_dataset,
)
from daliid_tpu_torch.data.synthetic import make_synthetic_dataset
from daliid_tpu_torch.data.turbulence import turbulence_path

__all__ = [
    "ReidTable",
    "data_root",
    "dataset_statistics",
    "load_briar_manifests",
    "load_dataset",
    "load_eval_splits",
    "load_multiple_datasets",
    "load_text_dataset",
    "merge_train_tables",
    "parse_deepchange_list",
    "parse_manifest",
    "parse_market_duke_dir",
    "parse_msmt17_list",
    "parse_veri_dir",
    "parse_veri_wild_list",
    "register_dataset",
    "make_synthetic_dataset",
    "turbulence_path",
]
