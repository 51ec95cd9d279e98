"""EigenSNP hyperparameter sweep executor, on the port.

Counterpart of `genomic_pca_tpu/eval/sweep_run.py` (the reference's
tests/sweep_run.py): one-at-a-time sweeps over the seven EigenSNP knobs
plus a base-defaults run (the same `DEFAULT_SWEEPS`, `default_params`
and 31 run ids), executed in a process pool, stdout/stderr logged per
run, rows appended to `sweeps_summary.tsv` in the reference's schema
(run_id, swept parameter/value, duration_seconds, success, command).

Each run is `python -m genomic_pca_tpu_torch --eigensnp ...`, whose CLI
runs on the card only: on a machine without one every run exits 1 and
is recorded with success False.  The JAX runner's `--cpu` flag (it only
strips the TPU grant's environment from the children) is not carried
over.

    python -m genomic_pca_tpu_torch.eval.sweep_run --bed-file <p> \
        --ld-block-file <blocks.tsv> --output-dir <dir> --jobs 1
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

DEFAULT_SWEEPS: Dict[str, List] = {
    "eigensnp_min_maf": [0.001, 0.03, 0.06, 0.25],
    "eigensnp_max_hwe_p": [5e-8, 5e-5, 1e-4, 0.001, 0.01, 0.1],
    "eigensnp_components_per_block": [2, 8, 18, 22, 50],
    "eigensnp_local_oversampling": [1, 8, 15],
    "eigensnp_local_power_iter": [1, 3, 5, 10],
    "eigensnp_snp_strip_size": [3000, 7500, 12000, 30000],
    "eigensnp_refine_passes": [4, 6, 8, 12],
}


def default_params(threads: int) -> Dict:
    return {
        "eigensnp_k_global": 10,
        "eigensnp_min_call_rate": 0.98,
        "eigensnp_min_maf": 0.01,
        "eigensnp_max_hwe_p": 1e-6,
        "eigensnp_components_per_block": 7,
        "eigensnp_subset_factor": 0.075,
        "eigensnp_min_subset_size": 10_000,
        "eigensnp_max_subset_size": 40_000,
        "eigensnp_global_oversampling": 10,
        "eigensnp_global_power_iter": 2,
        "eigensnp_local_oversampling": 10,
        "eigensnp_local_power_iter": 2,
        "eigensnp_seed": 2025,
        "eigensnp_snp_strip_size": 2000,
        "eigensnp_refine_passes": 1,
        "threads": threads,
        "log_level": "Warn",
    }


def generate_run_configs(
    base_output_dir: Path, threads: int, sweeps: Optional[Dict] = None
) -> List[Dict]:
    """One-at-a-time sweep configs + a base-defaults run."""
    sweeps = DEFAULT_SWEEPS if sweeps is None else sweeps
    defaults = default_params(threads)
    configs: List[Dict] = []
    counter = 1

    base = defaults.copy()
    base.update(
        run_id=f"run_{counter:03d}_base_defaults",
        swept_param_name="N/A (Base Defaults)",
        swept_param_value="N/A",
    )
    configs.append(base)

    for param, values in sweeps.items():
        for value in values:
            if value == defaults.get(param) and param != "eigensnp_min_maf":
                continue
            counter += 1
            cfg = defaults.copy()
            cfg[param] = value
            if param == "eigensnp_min_subset_size":
                cfg["eigensnp_max_subset_size"] = max(
                    defaults["eigensnp_max_subset_size"], value
                )
            elif param == "eigensnp_max_subset_size":
                cfg["eigensnp_min_subset_size"] = min(
                    defaults["eigensnp_min_subset_size"], value
                )
            value_str = str(value)
            if isinstance(value, float) and "e-" in value_str.lower():
                value_str = f"{value:.0e}".replace("-0", "-")
            cfg.update(
                run_id=f"run_{counter:03d}_{param.replace('eigensnp_', '')}_{value_str}",
                swept_param_name=param,
                swept_param_value=value,
            )
            configs.append(cfg)
    for cfg in configs:
        cfg["output_dir"] = str(base_output_dir / cfg["run_id"])
        cfg["output_prefix"] = str(
            base_output_dir / cfg["run_id"] / "eigensnp_results"
        )
    return configs


def build_command(cfg: Dict, bed_file: str, ld_block_file: str) -> List[str]:
    cmd = [
        sys.executable, "-m", "genomic_pca_tpu_torch",
        "--eigensnp",
        "--bed-file", bed_file,
        "--ld-block-file", ld_block_file,
        "-o", cfg["output_prefix"],
    ]
    for key in (
        "eigensnp_k_global eigensnp_min_call_rate eigensnp_min_maf "
        "eigensnp_max_hwe_p eigensnp_components_per_block "
        "eigensnp_subset_factor eigensnp_min_subset_size "
        "eigensnp_max_subset_size eigensnp_global_oversampling "
        "eigensnp_global_power_iter eigensnp_local_oversampling "
        "eigensnp_local_power_iter eigensnp_seed eigensnp_snp_strip_size "
        "eigensnp_refine_passes threads log_level"
    ).split():
        flag = "--" + key.replace("_", "-")
        cmd.extend([flag, str(cfg[key])])
    return cmd


def execute_single_run(args) -> Dict:
    """One run `(cfg, bed_file, ld_block_file)`: the CLI's exit code
    decides `success`; its output goes to the run directory's
    stdout.log / stderr.log."""
    cfg, bed_file, ld_block_file = args
    out_dir = Path(cfg["output_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = build_command(cfg, bed_file, ld_block_file)
    t0 = time.time()
    with open(out_dir / "stdout.log", "w") as out, open(
        out_dir / "stderr.log", "w"
    ) as err:
        proc = subprocess.run(cmd, stdout=out, stderr=err)
    return {
        "run_id": cfg["run_id"],
        "swept_param_name": cfg["swept_param_name"],
        "swept_param_value": cfg["swept_param_value"],
        "duration_seconds": round(time.time() - t0, 2),
        "success": proc.returncode == 0,
        "command": " ".join(cmd),
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="EigenSNP parameter sweeps.")
    p.add_argument("--bed-file", required=True)
    p.add_argument("--ld-block-file", required=True)
    p.add_argument("--output-dir", default="./eigensnp_sweeps_output")
    p.add_argument("--jobs", type=int, default=max(1, (os.cpu_count() or 4) // 4),
                   help="Concurrent runs (they share the card).")
    p.add_argument("--threads-per-job", type=int, default=2)
    args = p.parse_args(argv)

    base_dir = Path(args.output_dir).resolve()
    base_dir.mkdir(parents=True, exist_ok=True)
    configs = generate_run_configs(base_dir, args.threads_per_job)
    print(f"Generated {len(configs)} run configurations.")

    summary_path = base_dir / "sweeps_summary.tsv"
    write_header = not summary_path.exists()
    work = [(cfg, args.bed_file, args.ld_block_file) for cfg in configs]

    with open(summary_path, "a") as fh:
        if write_header:
            fh.write(
                "run_id\tswept_param_name\tswept_param_value\t"
                "duration_seconds\tsuccess\tcommand\n"
            )
        # spawn: the package imports torch, whose threads make fork unsafe.
        with ProcessPoolExecutor(args.jobs,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            for res in pool.map(execute_single_run, work):
                fh.write(
                    f"{res['run_id']}\t{res['swept_param_name']}\t"
                    f"{res['swept_param_value']}\t{res['duration_seconds']}\t"
                    f"{res['success']}\t{res['command']}\n"
                )
                fh.flush()
                status = "OK " if res["success"] else "FAIL"
                print(f"[{status}] {res['run_id']} ({res['duration_seconds']}s)")
    print(f"Summary appended to {summary_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
