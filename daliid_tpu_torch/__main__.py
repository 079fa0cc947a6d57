"""Umbrella entry point: ``python -m daliid_tpu_torch <command> [args...]``.

Port of ``daliid_tpu/__main__.py``, with all of its commands. Each
subcommand runs ``daliid_tpu_torch.cli.<module>`` as ``__main__`` with the
same flags as ``python -m daliid_tpu_torch.cli.<module>``.
"""

from __future__ import annotations

import runpy
import sys

COMMANDS = {
    "serve": ("cli.serve", "persistent identification daemon (TCP JSON protocol)"),
    "evaluate": ("cli.evaluate", "single-model evaluation (evaluate.py)"),
    "evaluate-ensemble": ("cli.evaluate_ensemble",
                          "two-model ensemble evaluation (evaluate_ensembled_models.py)"),
    "evaluate-fusion": ("cli.evaluate_fusion",
                        "clean+distorted magnitude fusion (evaluateCleanATModels.py)"),
    "export": ("cli.export", "checkpoint conversion: reference torch <-> JAX npz"),
    "search": ("cli.search", "gallery search service"),
    "stats": ("cli.stats", "dataset statistics tables"),
    "supervise": ("cli.supervise", "training supervisor: auto crash-resume, gang scheduling"),
    "train": ("cli.train", "training loop (mainKIT.py)"),
}


def _usage() -> str:
    lines = ["usage: python -m daliid_tpu_torch <command> [args...]", "", "commands:"]
    width = max(len(c) for c in COMMANDS)
    for name, (_, help_text) in COMMANDS.items():
        lines.append(f"  {name:<{width}}  {help_text}")
    lines.append("")
    lines.append("run `python -m daliid_tpu_torch <command> --help` for that command's flags")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        raise SystemExit(0 if argv else 2)
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r}\n\n{_usage()}", file=sys.stderr)
        raise SystemExit(2)
    module = f"daliid_tpu_torch.{COMMANDS[cmd][0]}"
    sys.argv = [f"python -m {module}"] + argv[1:]
    runpy.run_module(module, run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
