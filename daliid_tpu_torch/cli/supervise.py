"""Training supervisor: detect a dead trainer and resume it — port of
``daliid_tpu/cli/supervise.py``.

    python -m daliid_tpu_torch supervise [--max_restarts 3] -- \\
        --dataset Market --model_name resnet50 ...

Everything after ``--`` is the ``cli/train.py`` argv. On a nonzero exit the
trainer is relaunched with ``--resume``, which restores the newest of the
best and latest checkpoint channels, RNG streams included, so the stitched
run equals an uninterrupted one.

The restart budget counts progress (JAX ``main`` ``:207``): the counter
resets whenever a relaunch advances the newest checkpoint epoch
(``_latest_step`` ``:194``), so a long run survives any number of sporadic
faults, while a crash loop with no progress stops after ``--max_restarts``
consecutive futile restarts.

``--multihost N`` (``_run_gang`` ``:130``) gang-schedules N ranks of
``cli/train.py --multihost`` on one host, each with its ``--process_id``
and a fresh coordinator port per attempt. The death of any rank dooms the
gang (the survivors block in their next collective), so the supervisor lets
the survivors exit for ``--teardown_grace_seconds``, then sends SIGTERM and,
5 s later, SIGKILL, and relaunches every rank with ``--resume``. Once any
rank has exited, the rest must finish within ``--straggler_timeout`` or the
gang is torn down as hung. A gang that dies within 15 s of its launch,
before any checkpoint progress, is taken for a lost race for the probed
coordinator port and retried on a fresh port without spending the budget,
at most 3 times (``:55-56``, ``:268-281``). ``--multihost 1`` runs a 1-rank
gang (bootstrap included); ``0`` restarts one plain process.
``cli/train.py --fault_inject_epoch`` / ``--fault_inject_rank`` are the
drill's faults. A gang on several machines needs one supervisor per host
and the checkpoint directory on a shared filesystem.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

# a gang failure this soon after launch is taken for a coordinator
# bootstrap failure (the _free_port race) and retried on a fresh port
# without spending the restart budget, at most _MAX_BOOTSTRAP_RETRIES times
_BOOTSTRAP_WINDOW_SECONDS = 15.0
_MAX_BOOTSTRAP_RETRIES = 3
_TRAIN = "daliid_tpu_torch.cli.train"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DaliID training supervisor (auto crash-resume; PyTorch/CUDA)",
        usage="python -m daliid_tpu_torch supervise [options] -- <cli.train args>",
    )
    p.add_argument("--max_restarts", type=int, default=3,
                   help="consecutive restarts WITHOUT checkpoint progress before giving up "
                        "(the counter resets whenever a restart advances the newest "
                        "checkpoint epoch)")
    p.add_argument("--backoff_seconds", type=float, default=2.0,
                   help="sleep base between restarts (linear in the consecutive-failure count)")
    p.add_argument("--multihost", type=int, default=0, metavar="N",
                   help="gang-schedule N ranks over torch.distributed (localhost "
                        "coordinator; --process_id injected per rank); any rank failure "
                        "tears down the gang and relaunches every rank with --resume. "
                        "1 = a 1-rank gang (bootstrap included); 0 = one plain process "
                        "(default)")
    p.add_argument("--teardown_grace_seconds", type=float, default=10.0,
                   help="multihost: how long surviving ranks may exit on their own after a "
                        "rank failure before SIGTERM (then SIGKILL after 5 s)")
    p.add_argument("--straggler_timeout", type=float, default=600.0,
                   help="multihost watchdog: once ANY rank has exited, the others must "
                        "finish within this many seconds or the gang is torn down as hung; "
                        "0 disables")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="'--' followed by the full cli.train argv")
    return p


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _teardown(procs, grace_seconds: float) -> None:
    """Let the ranks exit on their own for the grace window, then SIGTERM,
    then SIGKILL 5 s later; reaps every process before returning."""
    deadline = time.time() + grace_seconds
    while time.time() < deadline and any(p.poll() is None for p in procs):
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 5.0
    while time.time() < deadline and any(p.poll() is None for p in procs):
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _run_gang(train_argv, num_processes: int, grace_seconds: float,
              straggler_timeout: float = 0.0) -> tuple[int, float | None]:
    """One attempt of an N-rank gang → ``(rc, fail_elapsed)``: rc 0 only
    when every rank exits 0; otherwise the first failing rank's code, after
    the survivors are torn down. ``fail_elapsed`` is the seconds from the
    launch to the first failure (None on success), measured before the
    teardown, for the bootstrap-failure test. A hang (a rank still running
    ``straggler_timeout`` s after the first exit) gives rc 1."""
    coord = f"127.0.0.1:{_free_port()}"
    t_launch = time.time()
    procs = []
    for r in range(num_processes):
        cmd = [sys.executable, "-m", _TRAIN, *train_argv, "--multihost",
               "--coordinator_address", coord, "--num_processes", str(num_processes),
               "--process_id", str(r)]
        procs.append(subprocess.Popen(cmd))
    print(f"[supervise] gang of {num_processes} ranks launched (coordinator {coord})",
          flush=True)
    first_exit_at = None
    while True:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            return 0, None
        failed = [(i, c) for i, c in enumerate(codes) if c is not None and c != 0]
        if failed:
            fail_elapsed = time.time() - t_launch
            r, rc = failed[0]
            alive = [i for i, c in enumerate(codes) if c is None]
            print(f"[supervise] rank {r} exited rc={rc} {fail_elapsed:.1f}s after launch"
                  + (f" — tearing down surviving rank(s) {alive}" if alive else ""),
                  flush=True)
            _teardown(procs, grace_seconds)
            return rc, fail_elapsed
        if any(c is not None for c in codes):
            if first_exit_at is None:
                first_exit_at = time.time()
            elif straggler_timeout > 0 and time.time() - first_exit_at > straggler_timeout:
                alive = [i for i, c in enumerate(codes) if c is None]
                print(f"[supervise] rank(s) {alive} still running {straggler_timeout:.0f}s "
                      f"after the first rank finished — treating the gang as hung and "
                      f"tearing it down", flush=True)
                _teardown(procs, grace_seconds)
                return 1, None  # a hang is never a bootstrap failure
        time.sleep(0.5)


def _latest_step(save_dir: str) -> int:
    """Newest checkpoint epoch (``<epoch>.pt``) across the best and latest
    channels; -1 when there is none yet."""
    newest = -1
    for d in (save_dir, os.path.join(save_dir, "latest")):
        if not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.isdigit():
                newest = max(newest, int(stem))
    return newest


def main(args) -> int:
    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not train_args:
        raise SystemExit("no train args given — usage: supervise [options] -- <cli.train args>")

    # the trainer's own parser reads the pass-through argv, so the checkpoint
    # location cannot drift from cli/train.py
    from daliid_tpu_torch.cli.train import build_argparser as train_argparser

    targs = train_argparser().parse_args(train_args)
    if targs.ckpt_freq <= 0:
        raise SystemExit("supervise requires the crash-resume channel: do not pass --ckpt_freq 0")
    if args.multihost < 0:
        raise SystemExit(f"--multihost must be >= 0, got {args.multihost}")
    if args.multihost >= 1 and (targs.multihost or targs.coordinator_address is not None
                                or targs.num_processes is not None
                                or targs.process_id is not None):
        raise SystemExit("supervise --multihost owns the rank bootstrap: do not pass "
                         "--multihost/--coordinator_address/--num_processes/--process_id "
                         "in the train argv")
    save_dir = targs.path_to_save_models

    failures_without_progress = 0
    bootstrap_retries = 0
    attempt = 0
    while True:
        attempt += 1
        argv = list(train_args)
        if attempt > 1 and "--resume" not in argv:
            argv.append("--resume")
        step_before = _latest_step(save_dir)
        fail_elapsed = None
        if args.multihost >= 1:
            print(f"[supervise] attempt {attempt}: {args.multihost}-rank gang of "
                  f"{_TRAIN} {' '.join(argv)}", flush=True)
            rc, fail_elapsed = _run_gang(argv, args.multihost, args.teardown_grace_seconds,
                                         args.straggler_timeout)
        else:
            cmd = [sys.executable, "-m", _TRAIN, *argv]
            print(f"[supervise] attempt {attempt}: {' '.join(cmd)}", flush=True)
            rc = subprocess.call(cmd)
        if rc == 0:
            print(f"[supervise] training completed after {attempt} attempt(s)", flush=True)
            return 0
        step_after = _latest_step(save_dir)
        if step_after > step_before:
            failures_without_progress = 0  # the run moved forward: the budget resets
        elif (fail_elapsed is not None and fail_elapsed < _BOOTSTRAP_WINDOW_SECONDS
              and bootstrap_retries < _MAX_BOOTSTRAP_RETRIES):
            # a rank dead within seconds of its launch most likely lost the
            # race for the probed port: a fresh port, no budget spent; bounded,
            # so a deterministic instant crash (bad flags) still gives up
            bootstrap_retries += 1
            print(f"[supervise] gang failed {fail_elapsed:.1f}s after launch (rc={rc}) — "
                  f"treating as a coordinator-bootstrap failure; free retry "
                  f"{bootstrap_retries}/{_MAX_BOOTSTRAP_RETRIES} on a fresh port", flush=True)
            continue
        else:
            failures_without_progress += 1
        print(f"[supervise] trainer exited rc={rc} (checkpoint epoch {step_before} -> "
              f"{step_after}; {failures_without_progress} consecutive failure(s) without "
              f"progress)", flush=True)
        if failures_without_progress > args.max_restarts:
            print(f"[supervise] no progress across {args.max_restarts} restarts — giving up",
                  file=sys.stderr, flush=True)
            return rc
        time.sleep(args.backoff_seconds * failures_without_progress)


if __name__ == "__main__":
    raise SystemExit(main(build_argparser().parse_args()))
