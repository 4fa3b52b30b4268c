"""Training-process killer (port of ``rvc_tpu/utils/py_kill.py``).

Kills the training processes whose PIDs the trainer recorded in each
experiment's ``heartbeat.json``, for one experiment or all of ``logs/``;
``--all-python`` signals every python process instead (scanning /proc).
SIGTERM by default, so that the trainer's emergency checkpoint runs.

    python -m rvc_tpu_torch.utils.py_kill [--logs_dir logs] [--force]
"""

from __future__ import annotations

import glob
import json
import os
import signal
from typing import List


def framework_pids(logs_dir: str = "logs") -> List[int]:
    """PIDs recorded in heartbeat.json files under `logs_dir`, excluding
    the calling process and PIDs that are no longer alive."""
    pids = []
    for hb_path in glob.glob(os.path.join(logs_dir, "*", "heartbeat.json")):
        try:
            with open(hb_path) as f:
                pid = json.load(f).get("pid")
        except (OSError, ValueError):
            continue
        if not isinstance(pid, int) or pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)  # existence probe only
        except (ProcessLookupError, PermissionError):
            continue
        pids.append(pid)
    return sorted(set(pids))


def all_python_pids() -> List[int]:
    """Every live python interpreter except this one, via /proc."""
    me = os.getpid()
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == me:
            continue
        try:
            with open(f"/proc/{entry}/comm") as f:
                name = f.read().strip()
        except OSError:
            continue
        if "python" in name.lower():
            pids.append(int(entry))
    return pids


def kill_pids(pids: List[int], sig: int = signal.SIGTERM) -> int:
    """Signal each PID; returns the number successfully signalled.
    SIGTERM by default so the trainer's emergency-checkpoint handler runs."""
    killed = 0
    for pid in pids:
        try:
            os.kill(pid, sig)
            killed += 1
        except (ProcessLookupError, PermissionError):
            pass
    return killed


def main() -> None:  # pragma: no cover - destructive CLI
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--logs_dir", default="logs",
                    help="experiments root holding heartbeat.json files")
    ap.add_argument("--all-python", action="store_true",
                    help="kill every python process")
    ap.add_argument("--force", action="store_true",
                    help="SIGKILL instead of SIGTERM (skips emergency save)")
    args = ap.parse_args()
    pids = all_python_pids() if args.all_python else framework_pids(args.logs_dir)
    sig = signal.SIGKILL if args.force else signal.SIGTERM
    n = kill_pids(pids, sig)
    print(f"signalled {n} process{'es' if n != 1 else ''}: {pids}")


if __name__ == "__main__":
    main()
