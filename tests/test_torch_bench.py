"""The port's bench and biobank script against the JAX ones, on the CPU.

`genomic_pca_tpu_torch/eval/biobank_bench.py` against
`scripts/biobank_bench.py` (loaded by path): the generated fileset byte for
byte on the numpy and the native path, the host residual certificate, the
device residual backend on CPU tensors against the host one, and the
subset oracle's exact side; `genomic_pca_tpu_torch/bench.py`: its JSON
keys against those of the root `bench.py` (read from its source), and its
refusal to run without a card unless `--device cpu` is given.
"""

import ast
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import genomic_pca_tpu.io.native as jnative
from genomic_pca_tpu_torch import bench
from genomic_pca_tpu_torch.eval import biobank_bench as tbb
from genomic_pca_tpu_torch.io import native as tnative

REPO = Path(__file__).resolve().parents[1]
FILES = ("biobank.bed", "biobank.bim", "biobank.fam", "blocks.tsv")
# A fileset on which the oracle's keep-list subset separates 4 PCs.
D, N, BLOCKS, K, SEED = 8192, 1024, 16, 4, 3


@pytest.fixture(scope="module")
def jbb():
    spec = importlib.util.spec_from_file_location(
        "jax_biobank_bench", REPO / "scripts" / "biobank_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    """The port's generator and workflow (in process, on the CPU) at k = 4."""
    out = tmp_path_factory.mktemp("biobank")
    tbb.generate(out, D, N, BLOCKS, SEED)
    run = tbb.run_workflow(out, K, split=False, device="cpu")
    return out, run


# ---------------------------------------------------------------------------
# (a) The generator, byte for byte.


@pytest.mark.parametrize("path", ["numpy", "native"])
def test_generate_bytes_match_jax(jbb, tmp_path, monkeypatch, path):
    if path == "numpy":
        monkeypatch.setattr(jnative, "synth_pack_native", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "synth_pack_native", lambda *a, **k: None)
    else:
        assert tnative.get_lib() is not None, "the port's native library did not load"
        if jnative.get_lib() is None:
            pytest.skip("the JAX package's native library did not load")
    jbb.generate(tmp_path / "j", 8192, 1024, n_blocks=16, seed=7)
    tbb.generate(tmp_path / "t", 8192, 1024, n_blocks=16, seed=7)
    for name in FILES:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_ensure_fileset_regenerates_on_another_size(tmp_path):
    tbb.ensure_fileset(tmp_path, 64, 16, 2, seed=1)
    first = (tmp_path / "biobank.bed").read_bytes()
    assert len(first) == tbb.bed_bytes(64, 16)
    (tmp_path / "biobank.fam").write_text("")  # kept: the BED's size is right
    tbb.ensure_fileset(tmp_path, 64, 16, 2, seed=1)
    assert (tmp_path / "biobank.fam").read_text() == ""
    tbb.ensure_fileset(tmp_path, 128, 16, 2, seed=1)
    assert (tmp_path / "biobank.bed").stat().st_size == tbb.bed_bytes(128, 16)
    assert (tmp_path / "biobank.fam").read_text().count("\n") == 16


# ---------------------------------------------------------------------------
# (b), (c) The residual certificate.


def test_workflow_in_process_reports_container_and_launches(fileset):
    _, run = fileset
    assert run["container"] == "device-resident 1d"
    assert run["launches"] == {}  # CPU tensors: the plain versions
    assert run["wall_seconds"] > 0


def test_host_residual_matches_jax(jbb, fileset):
    out, _ = fileset
    got = tbb.residual_certificate(out, backend="host")
    ref = jbb.residual_certificate(out, backend="host")
    assert got["backend"] == ref["backend"] == "host"
    np.testing.assert_allclose(got["residual_per_pc"], ref["residual_per_pc"], rtol=1e-6)
    np.testing.assert_allclose(got["max_residual"], ref["max_residual"], rtol=1e-6)
    np.testing.assert_allclose(got["rayleigh_eigenvalue_ratio_pc1"],
                               ref["rayleigh_eigenvalue_ratio_pc1"], rtol=1e-6)
    assert len(got["residual_per_pc"]) == K


def test_device_residual_on_cpu_tensors_matches_host(fileset):
    out, _ = fileset
    host = tbb.residual_certificate(out, backend="host")
    dev = tbb.residual_certificate(out, backend="device", device="cpu")
    assert dev["backend"] == "device"
    np.testing.assert_allclose(dev["residual_per_pc_unrounded"],
                               host["residual_per_pc_unrounded"], rtol=1e-4)
    # "auto" takes the host without a card.
    assert tbb.residual_certificate(out, backend="auto", device="cpu")["backend"] == "host"


def test_device_strip_unpack_is_the_code_map():
    # One byte per code: 0 -> 2, 1 -> missing, 2 -> 1, 3 -> 0, then a
    # partial byte whose pad fields are dropped.
    pk = torch.tensor([[0b11100100, 0b01010110]], dtype=torch.uint8)
    m = torch.tensor([0.5])
    iv = torch.tensor([2.0])
    v = torch.eye(6)
    gv = tbb._device_strip_gv(pk, m, iv, v, 6)
    x = torch.tensor([[3.0, 0.0, 1.0, -1.0, 1.0, 0.0]])
    torch.testing.assert_close(gv, x.T @ x)


# ---------------------------------------------------------------------------
# (d) The subset oracle.


def test_subset_oracle_exact_side_matches_jax(jbb, fileset):
    out, _ = fileset
    ref = jbb.subset_oracle(out, K, n_sub_blocks=BLOCKS, n_sub_samples=512)
    ref_ev = np.load(out / "oracle_scores.npz")["exact_eigenvalues"]
    got = tbb.subset_oracle(out, K, n_sub_blocks=BLOCKS, n_sub_samples=512, device="cpu")
    got_ev = np.load(out / "oracle_scores.npz")["exact_eigenvalues"]
    np.testing.assert_allclose(got_ev, ref_ev, rtol=1e-10)
    assert got["well_separated_k"] == ref["well_separated_k"] >= 2
    assert got["subset_samples"] == ref["subset_samples"] == 512
    assert got["subset_snps"] == ref["subset_snps"]
    assert got["per_pc_abs_r_min_separated"] > 0.99
    assert ref["per_pc_abs_r_min_separated"] > 0.99


# ---------------------------------------------------------------------------
# (e) The bench's JSON line against the JAX bench's keys.


def _jax_bench_keys():
    """(top-level keys, detail keys, oracle keys) of `main`'s line and
    (top-level, detail) of `main_biobank`'s, read from bench.py: the dict
    literal given to json.dumps, the `e2e` / `bio` dicts it spreads (their
    literal keys and `bio[...]` assignments), without `*_error` keys."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}

    def line_dict(fn):
        return next(n.args[0] for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and getattr(n.func, "attr", None) == "dumps")

    def keys(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    def detail(d):
        return d.values[[getattr(k, "value", None) for k in d.keys].index("detail")]

    main = fns["main"]
    spread = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id in ("e2e", "bio")
                    and isinstance(node.value, ast.Dict)):
                spread |= keys(node.value)
            if isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "bio":
                spread.add(t.slice.value)
    oracle = next(set(ast.literal_eval(g.iter)) for n in ast.walk(main)
                  if isinstance(n, ast.DictComp) for g in n.generators)
    top = line_dict(main)
    detail_keys = {k for k in keys(detail(top)) | spread if not k.endswith("_error")}
    bio_top = line_dict(fns["main_biobank"])
    return keys(top), detail_keys, oracle, keys(bio_top), keys(detail(bio_top))


TINY = bench.Shapes(2048, 256, 16, 2, 4, (1024, 128), (2048, 256), bio_blocks=16,
                    bio_k=4, oracle_blocks=16, oracle_samples=128)


def test_bench_json_keys_match_jax_bench(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(bench.tempfile, "tempdir", None)
    top, detail, oracle, _, _ = _jax_bench_keys()
    assert {"value_method", "trace_device_ms_per_iter", "eigensnp_e2e_seconds",
            "biobank_e2e_oracle", "biobank_full_scale_certified"} <= detail
    line = bench.run(torch.device("cpu"), TINY)
    assert set(line) == top
    # The one deliberate drop: the committed TPU certificate's mirror.
    assert set(line["detail"]) == detail - {"biobank_full_scale_certified"}
    assert set(line["detail"]["biobank_e2e_oracle"]) == oracle
    d = line["detail"]
    assert d["value_method"] in ("wall_clock_marginal", "wall_clock_direct_fallback")
    assert d["platform"] == "cpu"
    assert d["trace_device_ms_per_iter"] == {"unavailable": "no device trace under --device cpu"}
    assert d["trace_tflops_packed_q8"] is None and d["trace_tflops_dense_q8"] is None
    assert {"packed_q8", "dense_q8", "dense_bf16"} <= set(d["timing_method"])
    assert (d["n_snps"], d["n_samples"], d["sketch_width"]) == (2048, 256, 16)
    assert line["value"] == d["marginal_snps_per_sec"] > 0
    assert d["biobank_e2e_legs_seconds"] is None  # in process on the CPU
    assert (tmp_path / "gptpu_torch_bench_bio_2048x256" / "biobank.bed").exists()
    json.dumps(line)
    assert "Kernel launches packed_q8" not in capsys.readouterr().err  # no trace on the CPU


def test_bench_biobank_line_keys_match_jax_bench():
    _, _, _, top, detail = _jax_bench_keys()
    r = {"wall_seconds": 10.0, "legs": {"a": 1.0}, "container": "device-resident 2d"}
    line = bench.biobank_line(1024, 512, 40, r)
    assert set(line) == top
    assert set(line["detail"]) == detail
    assert line["detail"]["container"] == "device-resident 2d"
    assert line["value"] == 102.4


def test_bench_data_moments_are_exact():
    g, mean, inv = bench.make_data(64, 40, torch.device("cpu"), seed=5)
    x = g.numpy().astype(np.float64)
    assert set(np.unique(x)) <= {0.0, 1.0, 2.0}
    np.testing.assert_allclose(mean[:, 0].numpy(), x.mean(axis=1), rtol=1e-6)
    std = x.std(axis=1, ddof=1)
    np.testing.assert_allclose(inv[:, 0].numpy(), np.where(std > 0, 1 / std, 0),
                               rtol=1e-5)


def test_leg_log_parse():
    lines = [
        "[x INFO m] EigenSNP matrix loaded (device-resident container, 2d mode; "
        "stages 1-2 through the device-resident path) in 1.0s.",
        '[x INFO w] Kernel launches: {"right_apply_2d_q8": 0, "fused_right_apply_2d_packed": 2}',
    ]
    assert tbb.parse_leg_log(lines) == {
        "container": "device-resident 2d",
        "launches": {"fused_right_apply_2d_packed": 2}}
    assert tbb.parse_leg_log([]) == {"container": None, "launches": {}}


# ---------------------------------------------------------------------------
# (f) No implicit CPU.


@pytest.mark.parametrize("argv", [[], ["--biobank"]])
def test_bench_refuses_without_a_card(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(argv) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "CUDA" in err and "--device cpu" in err


def test_bench_biobank_needs_the_card(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--biobank", "--device", "cpu"])
    assert e.value.code == 2


def test_biobank_bench_refuses_without_a_card_before_generating(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "bb"
    assert tbb.main(["--out-dir", str(out), "--snps", "64", "--samples", "16",
                     "--blocks", "2"]) == 1
    assert not out.exists()
    assert "CUDA" in capsys.readouterr().err
    # Generation and the host residual need no card.
    assert tbb.main(["--out-dir", str(out), "--snps", "64", "--samples", "16",
                     "--blocks", "2", "--generate-only"]) == 0
    assert (out / "biobank.bed").stat().st_size == tbb.bed_bytes(64, 16)


def test_biobank_bench_host_residual_without_a_card(monkeypatch, fileset, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, _ = fileset
    copy = tmp_path / "fs"
    shutil.copytree(out, copy)
    args = ["--out-dir", str(copy), "--snps", str(D), "--samples", str(N),
            "--blocks", str(BLOCKS), "--k", str(K), "--skip-run", "--skip-oracle",
            "--residual-backend", "host"]
    assert tbb.main(args) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["config"] == {"snps": D, "samples": N, "k": K, "ld_blocks": BLOCKS}
    assert summary["residual"]["backend"] == "host"
    assert set(summary) == {"config", "residual"}
