"""Hyperparameter sweep launcher (C33 — the SLURM sweep tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/sweep.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Equivalent capability of VisualBERT/tools/sweeps/lib/slurm.py:15-361:
  * grid expansion over hyperparameter lists,
  * per-run save dirs with a code snapshot (git archive) so runs are
    hermetic,
  * run-state scanning (started/failed/finished) from log sentinels,
  * backends: local sequential, local multiprocess, or SLURM sbatch
    script emission with requeue support.

Usage:
    from transformer_mm_explainability_tpu_torch.tools.sweep import (
        Sweep, Param)
    sweep = Sweep("vqa_ft", "python -m ...cli perturbation",
                  [Param("lr", [1e-5, 5e-5]), Param("seed", [1, 2])])
    sweep.launch(backend="local")
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shlex
import subprocess
from typing import Any, Dict, List, Optional, Sequence

SENTINEL_STARTED = "TMMX_RUN_STARTED"
SENTINEL_FINISHED = "TMMX_RUN_FINISHED"
SENTINEL_FAILED = "TMMX_RUN_FAILED"


@dataclasses.dataclass
class Param:
    name: str
    values: Sequence[Any]


class Sweep:
    def __init__(self, name: str, base_command: str, params: List[Param],
                 sweep_root: str = "./sweeps"):
        self.name = name
        self.base_command = base_command
        self.params = params
        self.root = os.path.join(sweep_root, name)

    def grid(self) -> List[Dict[str, Any]]:
        names = [p.name for p in self.params]
        combos = itertools.product(*(p.values for p in self.params))
        return [dict(zip(names, c)) for c in combos]

    def run_dir(self, combo: Dict[str, Any]) -> str:
        tag = "_".join(f"{k}-{v}" for k, v in sorted(combo.items()))
        return os.path.join(self.root, tag or "run")

    def snapshot_code(self, run_dir: str) -> Optional[str]:
        """git-archive the working tree HEAD into the run dir (the
        reference's snapshot_code copy, slurm.py)."""
        snap = os.path.join(run_dir, "code.tar")
        try:
            subprocess.check_call(
                ["git", "archive", "-o", snap, "HEAD"],
                stderr=subprocess.DEVNULL)
            return snap
        except Exception:
            return None

    def command_for(self, combo: Dict[str, Any], run_dir: str) -> str:
        overrides = " ".join(f"{k}={v}" for k, v in combo.items())
        return (f"{self.base_command} {overrides} "
                f"2>&1 | tee -a {shlex.quote(os.path.join(run_dir, 'run.log'))}")

    # -- state scanning -----------------------------------------------------
    def state(self, combo: Dict[str, Any]) -> str:
        log = os.path.join(self.run_dir(combo), "run.log")
        if not os.path.exists(log):
            return "pending"
        text = open(log, errors="ignore").read()
        if SENTINEL_FINISHED in text:
            return "finished"
        if SENTINEL_FAILED in text:
            return "failed"
        if SENTINEL_STARTED in text:
            return "started"
        return "started"

    # -- backends -------------------------------------------------------------
    def launch(self, backend: str = "local", dry_run: bool = False,
               slurm_partition: str = "learnfair",
               requeue: bool = True) -> List[str]:
        """Returns the list of commands (local) or sbatch script paths."""
        outputs = []
        for combo in self.grid():
            run_dir = self.run_dir(combo)
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "params.json"), "w") as f:
                json.dump(combo, f)
            self.snapshot_code(run_dir)
            cmd = self.command_for(combo, run_dir)
            log = shlex.quote(os.path.join(run_dir, "run.log"))
            if backend == "local":
                outputs.append(cmd)
                if not dry_run:
                    # sentinels must land in run.log (what state()
                    # scans), not only the launcher's stdout
                    # pipefail: command_for pipes through tee, whose
                    # exit status would otherwise mask the command's
                    full = (f"set -o pipefail; "
                            f"echo {SENTINEL_STARTED} | tee -a {log}; "
                            f"({cmd}) && "
                            f"echo {SENTINEL_FINISHED} | tee -a {log} "
                            f"|| echo {SENTINEL_FAILED} | tee -a {log}")
                    subprocess.call(["bash", "-c", full])
            elif backend == "slurm":
                script = os.path.join(run_dir, "job.sbatch")
                with open(script, "w") as f:
                    f.write("#!/bin/bash\n")
                    f.write(f"#SBATCH --job-name={self.name}\n")
                    f.write(f"#SBATCH --partition={slurm_partition}\n")
                    f.write(f"#SBATCH --output={run_dir}/slurm.%j.out\n")
                    if requeue:
                        f.write("#SBATCH --requeue\n#SBATCH --open-mode=append\n")
                    f.write("set -o pipefail\n")
                    f.write(f"echo {SENTINEL_STARTED} | tee -a {log}\n")
                    # the inner bash -c is a fresh shell: it needs its
                    # own pipefail for the tee pipeline inside cmd
                    f.write(f"srun bash -c "
                            f"{shlex.quote('set -o pipefail; ' + cmd)} && "
                            f"echo {SENTINEL_FINISHED} | tee -a {log} "
                            f"|| echo {SENTINEL_FAILED} | tee -a {log}\n")
                outputs.append(script)
                if not dry_run:
                    subprocess.call(["sbatch", script])
            else:
                raise ValueError(f"unknown backend {backend}")
        return outputs
