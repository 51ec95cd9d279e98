"""Projection of new samples through a fitted model: the port against the
JAX package, on the CPU.

`transform` (float64 host), `transform_device` (dense container +
`left_apply`), `StripProjector` and `run_projection_workflow` of the port
against their JAX counterparts at tests/test_project.py's tolerances,
including the zero-std and center-only conventions; packed against dense
`left_apply`; a chunked projection against a one-strip one; and the
workflow's refusals of ambiguous, absent and allele-swapped SNPs.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from genomic_pca_tpu_torch.errors import DataPrepError
from genomic_pca_tpu.io.bed import write_plink
from genomic_pca_tpu.io.writers import write_loadings, write_moments
from genomic_pca_tpu.models import pca as jpca
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu.workflows import run_projection_workflow as jax_run_projection
from genomic_pca_tpu_torch.models import pca as tpca
from genomic_pca_tpu_torch.parallel import sharded as ts
from genomic_pca_tpu_torch.workflows import run_projection_workflow
from tests.conftest import make_genotypes


def _read_scores(path):
    lines = Path(path).read_text().splitlines()
    return [ln.split("\t", 1)[0] for ln in lines[1:]], np.asarray(
        [ln.split("\t")[1:] for ln in lines[1:]], dtype=np.float64)


def _case(rng, d, n_new, k, zero_std=False):
    g_train = make_genotypes(rng, d, 64, missing_rate=0.0)
    mean, std = ts.host_moments(g_train)
    if zero_std:
        std[::7] = 0.0
    g_new = make_genotypes(rng, d, n_new, missing_rate=0.05)
    loadings = rng.standard_normal((d, k)).astype(np.float32)
    return g_new, loadings, mean, std


@pytest.mark.parametrize("zero_std", [False, True])
def test_transform_matches_reference(rng, zero_std):
    g_new, loadings, mean, std = _case(rng, 400, 33, 4, zero_std)
    for s in (std, None):
        got = tpca.transform(g_new, loadings, mean, s)
        assert got.dtype == np.float32 and got.shape == (33, 4)
        np.testing.assert_array_equal(got, jpca.transform(g_new, loadings, mean, s))


@pytest.mark.parametrize("zero_std", [False, True])
def test_transform_device_matches_reference(rng, zero_std):
    """Against the JAX transform_device and the float64 host transform,
    center-only at the looser bar (uncentered scale)."""
    g_new, loadings, mean, std = _case(rng, 400, 33, 4, zero_std)
    mesh = make_mesh(jax.devices()[:1])
    for s, atol in ((std, 2e-4), (None, 2e-3)):
        got = tpca.transform_device(g_new, loadings, mean, s, device="cpu")
        ref = jpca.transform_device(g_new, loadings, mean, s, mesh=mesh)
        host = tpca.transform(g_new, loadings, mean, s)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=atol)
        np.testing.assert_allclose(got, host, rtol=2e-5, atol=atol)
    if zero_std:  # zero-std SNPs are inert: their loadings change nothing
        l2 = loadings.copy()
        l2[::7] = 0.0
        np.testing.assert_allclose(
            tpca.transform_device(g_new, l2, mean, std, device="cpu"),
            tpca.transform_device(g_new, loadings, mean, std, device="cpu"),
            rtol=1e-6, atol=1e-6)


def test_strip_projector_matches_reference(rng):
    d, n_new, k, strip = 700, 24, 4, 256
    g_new, loadings, mean, std = _case(rng, d, n_new, k)
    std[5] = 0.0
    for s, atol in ((std, 5e-4), (None, 2e-3)):
        ours = tpca.StripProjector(strip, n_new, k, device="cpu")
        theirs = jpca.StripProjector(strip, n_new, k, mesh=make_mesh(jax.devices()[:1]))
        acc = np.zeros((n_new, k), dtype=np.float32)
        for lo in range(0, d, strip):
            hi = min(lo + strip, d)
            part = ours(g_new[lo:hi], loadings[lo:hi], mean[lo:hi],
                        None if s is None else s[lo:hi])
            ref = theirs(g_new[lo:hi], loadings[lo:hi], mean[lo:hi],
                         None if s is None else s[lo:hi])
            np.testing.assert_allclose(part, ref, rtol=2e-5, atol=atol)
            acc += part
        np.testing.assert_allclose(acc, tpca.transform(g_new, loadings, mean, s),
                                   rtol=2e-5, atol=atol)
    with pytest.raises(ValueError, match="exceeds projector shape"):
        ours(g_new[:300], loadings[:300], mean[:300])


def test_left_apply_packed_matches_dense(rng):
    d, n, k = 512, 100, 4
    g = make_genotypes(rng, d, n, missing_rate=0.02)
    mean, std = ts.host_moments(g)
    w = rng.standard_normal((d, k)).astype(np.float32)
    sm_d = ts.ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                        device="cpu")
    sm_p = ts.ShardedMatrix.from_packed_rows(ts.pack_int8_rows(g), mean, std, n,
                                             "cpu")
    assert sm_p.packed and not sm_d.packed
    np.testing.assert_allclose(sm_p.left_apply(w), sm_d.left_apply(w),
                               rtol=2e-5, atol=2e-4)


def _model_files(tmp_path, rng, d, n, k, name="nb"):
    """A new-sample fileset of d SNPs x n samples and a fitted model over
    the same SNPs (loadings + moments TSVs)."""
    g = make_genotypes(rng, d, n, missing_rate=0.02)
    write_plink(str(tmp_path / name), g, bp=list(range(10, d * 10 + 10, 10)))
    mean, std = ts.host_moments(g)
    loadings = rng.standard_normal((d, k)).astype(np.float32)
    sids = [f"snp{i}" for i in range(d)]
    write_loadings(str(tmp_path / "m"), sids, ["1"] * d,
                   list(range(10, d * 10 + 10, 10)), loadings)
    write_moments(str(tmp_path / "m"), sids, mean, std, ["A"] * d, ["C"] * d)
    return (str(tmp_path / name), str(tmp_path / "m.eigensnp.loadings.tsv"),
            str(tmp_path / "m.eigensnp.moments.tsv"))


def test_projection_workflow_matches_reference(tmp_path, rng):
    bed, loads, moms = _model_files(tmp_path, rng, 700, 48, 3)
    jax_run_projection(bed, loads, moms, str(tmp_path / "ref"))
    run_projection_workflow(bed, loads, moms, str(tmp_path / "port"), device="cpu")
    ids_r, ref = _read_scores(tmp_path / "ref.projected.pca.tsv")
    ids_p, got = _read_scores(tmp_path / "port.projected.pca.tsv")
    assert ids_p == ids_r and got.shape == (48, 3)
    assert (Path(tmp_path / "port.projected.pca.tsv").read_text().splitlines()[0]
            == Path(tmp_path / "ref.projected.pca.tsv").read_text().splitlines()[0])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-4)


def test_projection_chunked_matches_single_strip(tmp_path, rng):
    """2,500 SNPs in strips of 1,024 rows (three, the last short) against
    one strip: projection is linear over SNP rows."""
    bed, loads, moms = _model_files(tmp_path, rng, 2500, 40, 3)
    run_projection_workflow(bed, loads, moms, str(tmp_path / "one"), device="cpu")
    run_projection_workflow(bed, loads, moms, str(tmp_path / "chk"),
                            projection_strip_rows=1024, device="cpu")
    _, one = _read_scores(tmp_path / "one.projected.pca.tsv")
    _, chk = _read_scores(tmp_path / "chk.projected.pca.tsv")
    np.testing.assert_allclose(chk, one, rtol=1e-4, atol=5e-4)


def _rewrite_bim(path, edit):
    lines = Path(path + ".bim").read_text().splitlines()
    Path(path + ".bim").write_text("\n".join(edit(lines)) + "\n")


@pytest.mark.parametrize("fault,match", [
    ("duplicate", "more than once"),
    ("absent", "absent from"),
    ("swapped", "A1/A2"),
    ("mismatch", "disagree on the SNP set"),
])
def test_projection_workflow_refusals(tmp_path, rng, fault, match):
    bed, loads, moms = _model_files(tmp_path, rng, 60, 12, 2)
    if fault == "duplicate":
        write_plink(bed, make_genotypes(rng, 61, 12), bp=list(range(10, 620, 10)),
                    sid=["snp0"] + [f"snp{i}" for i in range(60)])
    elif fault == "absent":
        _rewrite_bim(bed, lambda ls: [ls[0].replace("snp0", "other0")] + ls[1:])
    elif fault == "swapped":
        _rewrite_bim(bed, lambda ls: [ls[0].replace("\tA\tC", "\tC\tA")] + ls[1:])
    else:
        lines = Path(moms).read_text().splitlines()
        Path(moms).write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(DataPrepError, match=match):
        run_projection_workflow(bed, loads, moms, str(tmp_path / "o"), device="cpu")
    assert not list(tmp_path.glob("o.*"))
