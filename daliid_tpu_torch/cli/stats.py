"""Dataset statistics CLI — port of ``daliid_tpu/cli/stats.py``: the
per-split sample / identity / camera counts of one or more registered
datasets as a table (``dataset_statistics``), the same text as the JAX
command's.

Example::

    python -m daliid_tpu_torch stats --targets Market MSMT17 --data_root /data
"""

from __future__ import annotations

import argparse

from daliid_tpu_torch.data.registry import dataset_statistics


def main(argv=None):
    p = argparse.ArgumentParser(description="DaliID dataset statistics")
    p.add_argument("--targets", type=str, nargs="+", required=True)
    p.add_argument("--data_root", type=str, default=None)
    args = p.parse_args(argv)
    table = dataset_statistics(args.targets, root=args.data_root)
    print(table)
    return table


if __name__ == "__main__":
    main()
