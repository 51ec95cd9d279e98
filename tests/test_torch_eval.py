"""The port's eval chain against the JAX package's, on the CPU.

`eval/exact.py` (the oracle CLI, `--device cpu`; the default device
without CUDA exits 1), `eval/make_1000g_like.py` byte for byte against
`scripts/make_1000g_like.py`, `eval/sweep_run.py` (configs and commands
the JAX ones but for the module; a run without CUDA is a failure),
`eval/sweep_analyze.py` over run directories the port's EigenSNP
workflow wrote in process, against the JAX `analyze` over the same files,
and the copies `metrics`, `plot`, `video`, `subset` and `diskbench`,
mirroring tests/test_eval.py and tests/test_eval_extras.py.
"""

import importlib.util
import json
import logging
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from genomic_pca_tpu.eval import diskbench as jdiskbench
from genomic_pca_tpu.eval import exact as jexact
from genomic_pca_tpu.eval import metrics as jmetrics
from genomic_pca_tpu.eval import plot as jplot
from genomic_pca_tpu.eval import subset as jsubset
from genomic_pca_tpu.eval import sweep_analyze as janalyze
from genomic_pca_tpu.eval import sweep_run as jsweep
from genomic_pca_tpu_torch.eval import diskbench, metrics, plot, subset, sweep_analyze
from genomic_pca_tpu_torch.eval import exact as texact
from genomic_pca_tpu_torch.eval import make_1000g_like
from genomic_pca_tpu_torch.eval import sweep_run
from genomic_pca_tpu_torch.eval import video
from genomic_pca_tpu_torch.io.bed import write_plink
from tests.conftest import make_genotypes
from tests.test_eval import _fake_population_data

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def pop_files(tmp_path, rng):
    scores, samples = _fake_population_data(rng)
    pca_path = tmp_path / "toy.eigensnp.pca.tsv"
    sample_path = tmp_path / "igsr_samples.tsv"
    scores.to_csv(pca_path, sep="\t", index=False)
    samples.to_csv(sample_path, sep="\t", index=False)
    return str(pca_path), str(sample_path)


def _read_tsv_values(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [line.split("\t") for line in lines[1:]]


# ---------------------------------------------------------------------------
# eval/exact.py


def test_exact_cli_matches_reference(tmp_path, rng):
    geno = make_genotypes(rng, 300, 30, missing_rate=0.01)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno)
    args = ["--bed-prefix", prefix, "--k-components", "5", "--variant-chunk", "128"]
    assert texact.main(args + ["--out-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jexact.main(args + ["--out-dir", str(tmp_path / "j")]) == 0
    for name in ("pca.tsv", "py.eigenvalues.tsv"):
        head_t, rows_t = _read_tsv_values(tmp_path / "t" / name)
        head_j, rows_j = _read_tsv_values(tmp_path / "j" / name)
        assert head_t == head_j, name
        assert len(rows_t) == len(rows_j) == (30 if name == "pca.tsv" else 5)
        if name == "pca.tsv":
            assert [r[-1] for r in rows_t] == [r[-1] for r in rows_j]
            got = np.array([r[:-1] for r in rows_t], dtype=float)
            ref = np.array([r[:-1] for r in rows_j], dtype=float)
            got *= np.sign((got * ref).sum(axis=0))  # eigenvector signs
        else:
            assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
            got = np.array([r[1] for r in rows_t], dtype=float)
            ref = np.array([r[1] for r in rows_j], dtype=float)
        # Both print %.6g of float64 values that agree to ~1e-13.
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)


def test_exact_cli_without_cuda_exits_1(tmp_path, rng, caplog):
    write_plink(str(tmp_path / "toy"), make_genotypes(rng, 40, 12))
    with caplog.at_level(logging.ERROR):
        rc = texact.main(["--bed-prefix", str(tmp_path / "toy"),
                          "--out-dir", str(tmp_path / "o")])
    assert rc == 1
    assert "CUDA" in caplog.text
    assert not (tmp_path / "o").exists()


# ---------------------------------------------------------------------------
# eval/make_1000g_like.py


def test_make_1000g_like_byte_for_byte(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_1000g_like_original", REPO / "scripts" / "make_1000g_like.py")
    original = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(original)
    got = make_1000g_like.make_dataset(str(tmp_path / "t"), 2000, 200, 10, seed=7)
    ref = original.make_dataset(str(tmp_path / "j"), 2000, 200, 10, seed=7)
    assert [Path(p).name for p in got] == [Path(p).name for p in ref]
    for name in ("chr22.bed", "chr22.bim", "chr22.fam", "igsr_samples.tsv",
                 "blocks.tsv"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    assert len((tmp_path / "t" / "blocks.tsv").read_text().splitlines()) == 10


# ---------------------------------------------------------------------------
# eval/sweep_run.py


def _jax_module_name(cmd):
    return [("genomic_pca_tpu_torch" if c == "genomic_pca_tpu" else c) for c in cmd]


def test_sweep_configs_and_commands_match_reference(tmp_path):
    assert sweep_run.DEFAULT_SWEEPS == jsweep.DEFAULT_SWEEPS
    assert sweep_run.default_params(3) == jsweep.default_params(3)
    got = sweep_run.generate_run_configs(tmp_path, threads=2)
    ref = jsweep.generate_run_configs(tmp_path, threads=2)
    assert got == ref and len(got) == 31
    assert got[0]["run_id"] == "run_001_base_defaults"
    for cfg in got:
        cmd = sweep_run.build_command(cfg, "x.bed", "b.tsv")
        assert cmd[1:3] == ["-m", "genomic_pca_tpu_torch"]
        assert cmd == _jax_module_name(jsweep.build_command(cfg, "x.bed", "b.tsv"))
    sub = {"eigensnp_min_maf": [0.03], "eigensnp_refine_passes": [1, 4]}
    assert (sweep_run.generate_run_configs(tmp_path, 1, sweeps=sub)
            == jsweep.generate_run_configs(tmp_path, 1, sweeps=sub))


def test_sweep_run_without_cuda_is_a_failure(tmp_path, rng):
    write_plink(str(tmp_path / "toy"), make_genotypes(rng, 40, 12),
                bp=list(range(10, 410, 10)))
    (tmp_path / "blocks.tsv").write_text("1 1 500\n")
    cfg = sweep_run.generate_run_configs(tmp_path / "sweeps", 1, sweeps={})[0]
    res = sweep_run.execute_single_run(
        (cfg, str(tmp_path / "toy.bed"), str(tmp_path / "blocks.tsv")))
    assert res["success"] is False
    assert res["run_id"] == "run_001_base_defaults"
    assert "CUDA" in (Path(cfg["output_dir"]) / "stderr.log").read_text()
    assert not list(Path(cfg["output_dir"]).glob("*.pca.tsv"))


# ---------------------------------------------------------------------------
# eval/sweep_analyze.py over runs the port's workflow wrote in process.


def test_sweep_analyze_matches_reference(tmp_path, rng, pop_files):
    from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu_torch.workflows import run_eigensnp_workflow

    _, sample_path = pop_files
    iids = list(pd.read_csv(sample_path, sep="\t")["Sample name"])
    geno = make_genotypes(rng, 200, len(iids), n_pops=3, fst=0.3)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 2010, 10)), iid=iids)
    (tmp_path / "blocks.tsv").write_text("1 1 3000\n")

    sweep_dir = tmp_path / "sweeps"
    sweep_dir.mkdir()
    rows = []
    for i, k in enumerate([4, 6]):
        run_id = f"run_{i + 1:03d}_components_per_block_{k}"
        (sweep_dir / run_id).mkdir()
        run_eigensnp_workflow(
            DataPrepConfig(bed_path=prefix, ld_block_path=str(tmp_path / "blocks.tsv"),
                           snp_chunk_size=128),
            EigenSnpConfig(k_global=4, components_per_block=k, min_subset_size=5,
                           snp_strip_size=128, seed=2025),
            str(sweep_dir / run_id / "res"), device="cpu")
        rows.append(f"{run_id}\teigensnp_components_per_block\t{k}\t1.0\tTrue\tcmd\n")
    (sweep_dir / "sweeps_summary.tsv").write_text(
        "run_id\tswept_param_name\tswept_param_value\tduration_seconds\tsuccess\t"
        "command\n" + "".join(rows))
    assert texact.main(["--bed-prefix", prefix, "--out-dir", str(tmp_path / "exact"),
                        "--k-components", "4", "--device", "cpu"]) == 0
    # Each analyzer gets its own copy of the files: each writes metric
    # caches beside them, and a cache read back would stand in for a
    # computed table.
    shutil.copytree(tmp_path / "exact", tmp_path / "exact_j")
    shutil.copytree(sweep_dir, tmp_path / "sweeps_j")

    got = sweep_analyze.analyze(str(sweep_dir), sample_path, number_of_pcs=4,
                                exact_pca_file=str(tmp_path / "exact" / "pca.tsv"),
                                jobs=1, make_plots=True)
    ref = janalyze.analyze(str(tmp_path / "sweeps_j"), sample_path, number_of_pcs=4,
                           exact_pca_file=str(tmp_path / "exact_j" / "pca.tsv"),
                           jobs=1, make_plots=False)
    assert sweep_analyze.METRIC_COLS == janalyze.METRIC_COLS
    assert len(got) == 3
    assert got["swept_param_name"].iloc[-1] == "Exact PCA Reference"
    assert got[sweep_analyze.METRIC_COLS].notna().all().all()
    pd.testing.assert_frame_equal(got, ref, check_exact=True)
    assert (sweep_dir / "sweep_metrics_summary.tsv").read_bytes() == (
        tmp_path / "sweeps_j" / "sweep_metrics_summary.tsv").read_bytes()
    assert len(list(sweep_dir.glob("*/*.metrics_cache.tsv"))) == 2
    assert (sweep_dir / "sweep_runtime.png").exists()


# ---------------------------------------------------------------------------
# eval/metrics.py, plot.py, video.py, subset.py, diskbench.py


def test_metrics_cli_matches_reference(tmp_path, pop_files):
    pca_path, sample_path = pop_files
    args = ["--pca_file", pca_path, "--sample_file", sample_path,
            "--number_of_pcs", "4", "--mc_samples", "400"]
    assert metrics.main(args + ["--output_tsv", str(tmp_path / "t.tsv")]) == 0
    assert jmetrics.main(args + ["--output_tsv", str(tmp_path / "j.tsv")]) == 0
    assert metrics.COLUMNS == jmetrics.COLUMNS
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    df = pd.read_csv(tmp_path / "t.tsv", sep="\t")
    eur = df[df["Superpopulation"] == "EUR"].iloc[0]
    assert eur["LogReg_Balanced_Accuracy_CV"] > 0.9
    assert eur["HDBSCAN_adjusted_mutual_information"] > 0.8


def test_metrics_jsd_and_contrastive_match_reference(rng):
    x = np.vstack([rng.normal(0, 1, (60, 3)), rng.normal(4, 1, (60, 3))])
    labels = np.array(["a"] * 60 + ["b"] * 60)
    kt, _ = metrics._fit_kdes(x, labels)
    kj, _ = jmetrics._fit_kdes(x, labels)
    assert (metrics.monte_carlo_jsd(kt["a"], kt["b"], 400)
            == jmetrics.monte_carlo_jsd(kj["a"], kj["b"], 400))
    assert abs(metrics.monte_carlo_jsd(kt["a"], kt["a"], 400)) < 1e-6
    assert (metrics.contrastive_violation_stats(x, labels)
            == jmetrics.contrastive_violation_stats(x, labels))


def test_plot_harness(tmp_path, pop_files, rng):
    pca_path, sample_path = pop_files
    parent = Path(pca_path).parent
    pd.DataFrame({"PC": [1, 2, 3, 4], "Eigenvalue": [4.0, 2.0, 1.0, 0.5]}).to_csv(
        parent / "toy.eigenvalues.tsv", sep="\t", index=False)
    pd.DataFrame({"VariantID": [f"v{i}" for i in range(50)], "Chrom": ["1"] * 50,
                  "Pos": np.arange(50) * 100, "PC1_loading": rng.normal(size=50),
                  "PC2_loading": rng.normal(size=50)}).to_csv(
        parent / "toy.eigensnp.loadings.tsv", sep="\t", index=False)
    assert plot.find_outputs(str(parent)) == jplot.find_outputs(str(parent))
    assert plot.main(["--results-dir", str(parent), "--sample-file", sample_path,
                      "--out-dir", str(tmp_path / "plots")]) == 0
    for name in ("scree.png", "pca.png", "loadings.png"):
        assert (tmp_path / "plots" / name).exists(), name
    groups = {"EUR": ["GBR", "FIN"], "AFR": ["YRI"]}
    assert plot.population_colors(groups) == jplot.population_colors(groups)


def test_video_frames_and_animation(tmp_path, rng):
    subpops = [("GBR", "EUR"), ("YRI", "AFR")]
    rows_s, rows_p = [], []
    for i in range(40):
        sub, spop = subpops[i % 2]
        rows_p.append([f"S{i}", rng.normal(), rng.normal()])
        rows_s.append([f"S{i}", sub, spop])
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    pd.DataFrame(rows_p, columns=["SampleID", "PC1", "PC2"]).to_csv(
        run_dir / "res.eigensnp.pca.tsv", sep="\t", index=False)
    sample_file = tmp_path / "samples.tsv"
    pd.DataFrame(rows_s, columns=["Sample name", "Population code",
                                  "Superpopulation code"]).to_csv(
        sample_file, sep="\t", index=False)
    frames = []
    for i in range(2):
        frame = tmp_path / f"frame{i}.png"
        assert video.generate_single_frame(run_dir, str(sample_file), frame)
        frames.append(frame)
    assert not video.generate_single_frame(tmp_path, str(sample_file),
                                           tmp_path / "none.png")
    out = video.assemble_animation(frames, tmp_path / "anim", fps=2)
    assert out is not None and out.exists() and out.suffix in (".mp4", ".gif")


@pytest.mark.parametrize("text", [
    ["chrom\tpos\n2\t500\n1\t100\nX\t50\nMT\t1\n", "1\t100\n1\t50\n10\t7\nchr2\t400\n"],
    ["XY\t10\nMT\t5\nchrY\t3\nX\t7\n22\t1\nchr1\t9\nM\t2\n10\t4\n2\t8\n"],
])
def test_subset_matches_reference(tmp_path, text):
    paths = []
    for i, t in enumerate(text):
        paths.append(tmp_path / f"in{i}.tsv")
        paths[-1].write_text(t)
    inputs = [str(p) for p in paths]
    n_t = subset.create_combined_subset_tsv(inputs, str(tmp_path / "t.tsv"))
    n_j = jsubset.create_combined_subset_tsv(inputs, str(tmp_path / "j.tsv"))
    assert n_t == n_j
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    for c in ("1", "chr22", "X", "y", "MT", "M", "XY", "GL000"):
        assert subset.chrom_sort_key(c) == jsubset.chrom_sort_key(c)


def test_diskbench_keys_match_reference(tmp_path, rng, capsys):
    write_plink(str(tmp_path / "toy"), make_genotypes(rng, 600, 40))
    args = ["--bed-prefix", str(tmp_path / "toy"), "--time-cap", "0.2",
            "--strip-size", "256"]
    assert diskbench.main(args) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jdiskbench.main(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(ref)
    assert all(v > 0 for v in got.values())
