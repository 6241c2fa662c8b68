"""Resume every interrupted detector training under a directory tree (port
of ``tools/resume_all.py``; the reference's spot-instance recovery script,
yolov3/utils/aws/resume.py).

Walks the tree for the port's ``last.pt`` checkpoints (``detect.train_loop``
``DetectorTrainer._save``) that sit beside the ``opt.yaml`` its CLI writes,
skips finished runs and unreadable checkpoints, rebuilds each training
command from ``opt.yaml`` and relaunches it with ``--resume last.pt``: the
model, optimizer, EMA, epoch and data streams continue exactly
(``DetectorTrainer.resume``).  A relaunched run trains on the device its
``opt.yaml`` names (``--device``, ``cuda`` by default); ``--dp`` and
``--tp`` come back as flags, so a data- or tensor-parallel run starts its
ranks again.

    python -m adaptiveisp_tpu_torch.resume_all [root] [--dry-run] [--parallel]

``--dry-run`` prints the commands and launches nothing; relaunches run one
after another unless ``--parallel`` (one process should own a card).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

MODULE = "adaptiveisp_tpu_torch.detect.train_loop"
# resume: replaced by the fresh --resume; evolve: a sweep resumes from its
# own evolve.csv, not from last.pt; weights: the restore overrides them
SKIP = frozenset({"resume", "evolve", "weights"})


def find_resumable(root: Path):
    """Yield (last_ckpt, opt_dict) for every unfinished run under root."""
    import torch
    import yaml

    for last in sorted(Path(root).rglob("last.pt")):
        opt_path = last.parent / "opt.yaml"
        if not opt_path.exists():
            continue
        with open(opt_path) as f:
            opt = yaml.safe_load(f) or {}
        try:
            ckpt = torch.load(last, map_location="cpu", weights_only=False)
        except Exception:
            continue
        if int(ckpt.get("epoch", -1)) + 1 >= int(opt.get("epochs", 0)):
            continue  # run completed
        yield last, opt


def resume_command(last: Path, opt: dict):
    """The trainer CLI's invocation rebuilt from opt.yaml, plus --resume.

    opt.yaml is ``vars(args)`` of ``train_loop.main``, so every argparse
    dest maps back to its flag: flags that change training (--optimizer,
    --linear-lr, --freeze, --rect, --dp, --tp, ...) survive the resume, or
    the restored optimizer state would run under another schedule."""
    cmd = [sys.executable, "-m", MODULE]
    for k, v in opt.items():
        if k in SKIP or v is None:
            continue
        flag = "--" + k.replace("_", "-")
        if isinstance(v, bool):
            if v:
                cmd.append(flag)
        elif isinstance(v, (list, tuple)):
            cmd += [flag] + [str(x) for x in v]
        else:
            cmd += [flag, str(v)]
    return cmd + ["--resume", str(last)]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m adaptiveisp_tpu_torch.resume_all")
    p.add_argument("root", nargs="?", default="runs",
                   help="directory tree to scan for last.pt checkpoints")
    p.add_argument("--dry-run", action="store_true",
                   help="print the resume commands without launching")
    p.add_argument("--parallel", action="store_true",
                   help="launch all resumes at once (default: one after "
                        "another, so one process owns the card)")
    args = p.parse_args(argv)

    cmds = [resume_command(last, opt)
            for last, opt in find_resumable(Path(args.root))]
    if not cmds:
        print(f"no resumable runs under {args.root}")
        return []
    procs = []
    for cmd in cmds:
        print(" ".join(cmd), flush=True)
        if args.dry_run:
            continue
        if args.parallel:
            procs.append(subprocess.Popen(cmd))
        else:
            subprocess.run(cmd, check=False)
    for pr in procs:
        pr.wait()
    return cmds


if __name__ == "__main__":
    main()
