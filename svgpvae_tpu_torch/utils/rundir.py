"""Run-directory layout and args dump (port of svgpvae_tpu/utils/rundir.py).

The reference's run-folder convention: a unique timestamped directory
with pics/, res/, preds/ and ckpt/ subfolders, a snapshot of the
package's source under sourcecode/, and an args.json of the full flag
set.
"""

from __future__ import annotations

import json
import os
import shutil
from datetime import datetime
from pathlib import Path
from typing import Optional


def make_checkpoint_folder(base_dir: str, expid: Optional[str] = None,
                           extra: str = "") -> str:
    """Create <base>/<expid>/<N>_<extra>__on__<timestamp>/{pics,res,preds,
    ckpt} and snapshot svgpvae_tpu_torch (less __pycache__ and the built
    kernels under _build/) into sourcecode/."""
    base = Path(base_dir)
    if expid is not None:
        base = base / expid
    base.mkdir(parents=True, exist_ok=True)

    now = datetime.now()
    stamp = (f"{now.day}_{now.month}_{now.year}__at__"
             f"{now.hour}_{now.minute}_{now.second}")
    run_dir = base / f"{len(os.listdir(base))}_{extra}__on__{stamp}"
    for sub in ("pics", "res", "preds", "ckpt"):
        (run_dir / sub).mkdir(parents=True)

    src_root = Path(__file__).resolve().parent.parent
    shutil.copytree(src_root, run_dir / "sourcecode" / src_root.name,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    return str(run_dir) + "/"


def dump_args(run_dir: str, args) -> None:
    """Write the experiment flags to args.json."""
    args_dict = vars(args) if not isinstance(args, dict) else args
    with open(Path(run_dir) / "args.json", "w") as f:
        json.dump(args_dict, f, indent=2, default=str)
