"""The port never imports jax, nor anything of the JAX package.

Each case runs in a fresh interpreter with jax blocked twice over:
`sys.modules["jax"] = None` in the process, and a stand-in `jax` package
that raises ImportError first on PYTHONPATH, so spawned worker processes
are blocked as well.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from tests.helpers import write_vcf

REPO = Path(__file__).resolve().parents[1]

PRELUDE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
""")

CHECK = textwrap.dedent("""
    loaded = [m for m, v in sys.modules.items() if v is not None and
              m.split(".")[0] in ("jax", "jaxlib", "genomic_pca_tpu")]
    assert not loaded, loaded
""")


@pytest.fixture
def blocked_env(tmp_path):
    fake = tmp_path / "blocked" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('jax is blocked in this process')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(fake.parent), str(REPO), env.get("PYTHONPATH", "")]
    ).rstrip(os.pathsep)
    env.pop("XLA_FLAGS", None)
    return env


def _run(args, env, cwd=REPO, timeout=240):
    return subprocess.run(
        [sys.executable, *args], env=env, cwd=cwd, capture_output=True,
        text=True, timeout=timeout,
    )


def test_port_modules_and_help_import_no_jax(blocked_env):
    code = PRELUDE + textwrap.dedent("""
        import genomic_pca_tpu_torch
        import genomic_pca_tpu_torch.cli
        import genomic_pca_tpu_torch.workflows
        import genomic_pca_tpu_torch.models.pca
        import genomic_pca_tpu_torch.models.prepare
        import genomic_pca_tpu_torch.models.eigensnp
        import genomic_pca_tpu_torch.utils.checkpoint
        import genomic_pca_tpu_torch.parallel.sharded
        import genomic_pca_tpu_torch.parallel.mesh
        import genomic_pca_tpu_torch.eval.multichip
        import genomic_pca_tpu_torch.ops.kernels
        import genomic_pca_tpu_torch.ops.build
        import genomic_pca_tpu_torch.ops.standardize
        import genomic_pca_tpu_torch.eval.profile_core
        import genomic_pca_tpu_torch.errors
        import genomic_pca_tpu_torch.config
        import genomic_pca_tpu_torch.io.bed
        import genomic_pca_tpu_torch.io.bgzf
        import genomic_pca_tpu_torch.io.ldblocks
        import genomic_pca_tpu_torch.io.native
        import genomic_pca_tpu_torch.io.prefetch
        import genomic_pca_tpu_torch.io.vcf
        import genomic_pca_tpu_torch.io.writers
        import genomic_pca_tpu_torch.ops.streaming
        import genomic_pca_tpu_torch.ops.stream
        import genomic_pca_tpu_torch.models.exact
        import genomic_pca_tpu_torch.eval.exact
        import genomic_pca_tpu_torch.eval.make_1000g_like
        import genomic_pca_tpu_torch.eval.sweep_run
        import genomic_pca_tpu_torch.eval.diskbench
        import genomic_pca_tpu_torch.eval.subset
        import genomic_pca_tpu_torch.eval.metrics
        import genomic_pca_tpu_torch.eval.sweep_analyze
        import genomic_pca_tpu_torch.eval.plot
        import genomic_pca_tpu_torch.eval.video
        import genomic_pca_tpu_torch.eval.biobank_bench
        import genomic_pca_tpu_torch.bench
    """) + CHECK
    proc = _run(["-c", code], blocked_env)
    assert proc.returncode == 0, proc.stderr
    proc = _run(["-m", "genomic_pca_tpu_torch", "--help"], blocked_env)
    assert proc.returncode == 0, proc.stderr
    assert "--vcf-dir" in proc.stdout and "--eigensnp" in proc.stdout


def test_parallel_vcf_parse_imports_no_jax(blocked_env, tmp_path, rng):
    d = tmp_path / "vcfs"
    d.mkdir()
    names = [f"s{i}" for i in range(12)]
    for f in range(4):
        write_vcf(d / f"part{f}.vcf", rng.integers(0, 3, (25, 12)), names,
                  start_pos=100 * f)
    code = PRELUDE + textwrap.dedent(f"""
        from genomic_pca_tpu_torch.workflows import load_vcf_directory
        samples, ids, strips = load_vcf_directory({str(d)!r}, 0.0, n_workers=4)
        assert samples == {names!r}
        assert sum(s.shape[0] for s in strips) == len(ids) == 100, len(ids)
    """) + CHECK
    proc = _run(["-c", code], blocked_env)
    assert proc.returncode == 0, proc.stderr


def test_cli_vcf_without_cuda_exits_1_naming_cuda(blocked_env, tmp_path):
    d = tmp_path / "vcfs"
    d.mkdir()
    write_vcf(d / "a.vcf", np.ones((5, 4), np.int8), ["a", "b", "c", "d"])
    blocked_env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run(["-m", "genomic_pca_tpu_torch", "-d", str(d), "-o",
                 str(tmp_path / "out"), "-k", "2", "-t", "4"], blocked_env)
    assert proc.returncode == 1
    assert "CUDA" in proc.stderr
    assert not list(tmp_path.glob("out*"))


@pytest.mark.parametrize("args", [
    ["-m", "genomic_pca_tpu_torch.eval.profile_core"],
    ["-m", "genomic_pca_tpu_torch.eval.multichip"],
    ["-m", "genomic_pca_tpu_torch.bench"],
    ["-m", "genomic_pca_tpu_torch.eval.biobank_bench"],
    [str(REPO / "chip_smoke.py")],
])
def test_gpu_scripts_without_cuda_exit_nonzero(blocked_env, args):
    blocked_env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run(args, blocked_env)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"ok"' not in proc.stdout


def _import_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("pkg", ["genomic_pca_tpu_torch"])
def test_no_port_module_imports_the_jax_package(pkg):
    """Every import statement of every module of the port, at any depth
    (lazy imports inside functions included), names neither jax nor the
    JAX package: the port keeps its own copies of what it needs."""
    files = sorted((REPO / pkg).rglob("*.py"))
    assert len(files) > 30
    bad = {str(f.relative_to(REPO)): sorted(r) for f in files
           if (r := _import_roots(f) & {"genomic_pca_tpu", "jax", "jaxlib"})}
    assert not bad, bad


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py reaches the JAX package's jax-free modules only
    through the port, so a fault there cannot pass on both sides of its
    checks."""
    roots = _import_roots(REPO / "chip_smoke.py")
    assert "genomic_pca_tpu_torch" in roots
    assert not roots & {"genomic_pca_tpu", "jax", "jaxlib"}, roots


@pytest.mark.parametrize("flags", [
    ["-d", "x", "-k", "2", "--profile-dir", "p"],
    ["--eigensnp", "--bed-file", "x", "--ld-block-file", "y",
     "--eigensnp-qc-mode", "device"],
])
def test_cli_unported_modes_exit_1(blocked_env, tmp_path, flags):
    """`--profile-dir` and `--eigensnp-qc-mode device` (once refused as
    not yet ported) parse with jax blocked; without CUDA the run exits 1
    naming CUDA."""
    blocked_env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run(["-m", "genomic_pca_tpu_torch", "-o", str(tmp_path / "o"),
                 *flags], blocked_env)
    assert proc.returncode == 1
    assert "CUDA" in proc.stderr
    assert "not yet ported" not in proc.stderr


def test_cli_project_without_cuda_exits_1_naming_cuda(blocked_env, tmp_path):
    blocked_env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run(["-m", "genomic_pca_tpu_torch", "-o", str(tmp_path / "out"),
                 "--project", "--bed-file", "x", "--project-loadings", "l",
                 "--project-moments", "m"], blocked_env)
    assert proc.returncode == 1
    assert "CUDA" in proc.stderr
    assert not list(tmp_path.glob("out*"))


@pytest.mark.parametrize("flags", [
    ["--project", "--bed-file", "x"],
    ["--project", "--eigensnp", "--bed-file", "x", "--project-loadings", "l",
     "--project-moments", "m"],
])
def test_cli_project_flag_errors_exit_2(blocked_env, tmp_path, flags):
    proc = _run(["-m", "genomic_pca_tpu_torch", "-o", str(tmp_path / "o"),
                 *flags], blocked_env)
    assert proc.returncode == 2
    assert "--project" in proc.stderr


def _plink_fileset(tmp_path):
    from genomic_pca_tpu.io.bed import write_plink

    geno = np.random.default_rng(3).integers(0, 3, (40, 12)).astype(np.int8)
    write_plink(tmp_path / "toy", geno, bp=list(range(10, 410, 10)))
    (tmp_path / "blocks.tsv").write_text("1 1 200\n1 201 400\n")
    return ["--eigensnp", "--bed-file", str(tmp_path / "toy"),
            "--ld-block-file", str(tmp_path / "blocks.tsv")]


def test_cli_eigensnp_without_cuda_exits_1_naming_cuda(blocked_env, tmp_path):
    blocked_env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run(["-m", "genomic_pca_tpu_torch", "-o", str(tmp_path / "out"),
                 *_plink_fileset(tmp_path)], blocked_env)
    assert proc.returncode == 1
    assert "CUDA" in proc.stderr
    assert not list(tmp_path.glob("out*"))


def test_cli_eigensnp_compile_only_is_a_no_op(blocked_env, tmp_path):
    blocked_env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run(["-m", "genomic_pca_tpu_torch", "-o", str(tmp_path / "out"),
                 *_plink_fileset(tmp_path), "--eigensnp-compile-only"], blocked_env)
    assert proc.returncode == 0, proc.stderr
    assert not list(tmp_path.glob("out*"))
