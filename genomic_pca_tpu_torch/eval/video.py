"""Sweep animation generator.

A copy of `genomic_pca_tpu/eval/video.py` (the reference's
tests/video.py) over the port's `eval/metrics.py` and `eval/plot.py`: for
each swept parameter, renders a PC-scatter frame per sweep run (via
eval/plot.py), orders frames by the parameter value, and assembles an
animation — MP4 via ffmpeg when available, animated GIF via Pillow
otherwise.
"""

from __future__ import annotations

import argparse
import logging
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import pandas as pd

log = logging.getLogger(__name__)


def generate_single_frame(
    run_dir: Path, sample_file: str, frame_path: Path
) -> bool:
    """Render the PC scatter for one sweep run into frame_path."""
    from genomic_pca_tpu_torch.eval.metrics import load_and_merge
    from genomic_pca_tpu_torch.eval.plot import find_outputs, plot_pc_scatters

    pca_path, _, _ = find_outputs(str(run_dir))
    if pca_path is None:
        return False
    try:
        pca_df = pd.read_csv(pca_path, sep="\t")
        n_pcs = sum(1 for c in pca_df.columns if c.startswith("PC"))
        merged, pc_cols = load_and_merge(str(pca_path), sample_file, n_pcs)
        plot_pc_scatters(merged, pc_cols, str(frame_path), max_pairs=1)
        return True
    except Exception as e:
        log.warning("Frame render failed for %s: %s", run_dir, e)
        return False


def assemble_animation(frames: List[Path], out_base: Path, fps: int = 2) -> Optional[Path]:
    """MP4 via ffmpeg when present, else GIF via Pillow."""
    if not frames:
        return None
    if shutil.which("ffmpeg"):
        out = out_base.with_suffix(".mp4")
        list_file = out_base.with_suffix(".frames.txt")
        with open(list_file, "w") as fh:
            for f in frames:
                fh.write(f"file '{f.resolve()}'\nduration {1.0/fps}\n")
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-f", "concat", "-safe", "0", "-i",
                 str(list_file), "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
                 "-pix_fmt", "yuv420p", str(out)],
                check=True, capture_output=True,
            )
            return out
        except subprocess.CalledProcessError as e:
            log.warning("ffmpeg failed (%s); falling back to GIF.", e)
    try:
        from PIL import Image

        out = out_base.with_suffix(".gif")
        imgs = [Image.open(f) for f in frames]
        imgs[0].save(
            out, save_all=True, append_images=imgs[1:],
            duration=int(1000 / fps), loop=0,
        )
        return out
    except ImportError:
        log.warning("Neither ffmpeg nor Pillow available; no animation.")
        return None


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Animate sweep results.")
    p.add_argument("--sweep-dir", required=True)
    p.add_argument("--sample-file", required=True)
    p.add_argument("--fps", type=int, default=2)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    base = Path(args.sweep_dir)
    summary = pd.read_csv(base / "sweeps_summary.tsv", sep="\t")
    made = 0
    for param in summary["swept_param_name"].unique():
        if not isinstance(param, str) or not param.startswith("eigensnp_"):
            continue
        rows = summary[summary["swept_param_name"] == param].copy()
        rows["_v"] = pd.to_numeric(rows["swept_param_value"], errors="coerce")
        rows = rows.sort_values("_v")
        frames: List[Path] = []
        for _, row in rows.iterrows():
            run_dir = base / str(row["run_id"])
            frame = run_dir / "frame_pca.png"
            if frame.exists() or generate_single_frame(
                run_dir, args.sample_file, frame
            ):
                frames.append(frame)
        out = assemble_animation(
            frames, base / f"sweep_{param.replace('eigensnp_', '')}",
            fps=args.fps,
        )
        if out:
            log.info("Wrote %s (%d frames)", out, len(frames))
            made += 1
    print(f"Created {made} animations.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
