"""The port's copies of the JAX package's jax-free modules against the
originals, on the same inputs: the PLINK reader, the LD-block parser, the
TSV writers and readers, the strip prefetcher, BGZF, the configuration
classes and the error classes."""

import dataclasses
import time

import numpy as np
import pytest

from genomic_pca_tpu import config as jcfg
from genomic_pca_tpu import errors as jerr
from genomic_pca_tpu.io import bed as jbed
from genomic_pca_tpu.io import bgzf as jbgzf
from genomic_pca_tpu.io import ldblocks as jld
from genomic_pca_tpu.io import native as jnative
from genomic_pca_tpu.io import prefetch as jpf
from genomic_pca_tpu.io import writers as jw
from genomic_pca_tpu_torch import config as tcfg
from genomic_pca_tpu_torch import errors as terr
from genomic_pca_tpu_torch.io import bed as tbed
from genomic_pca_tpu_torch.io import bgzf as tbgzf
from genomic_pca_tpu_torch.io import ldblocks as tld
from genomic_pca_tpu_torch.io import native as tnative
from genomic_pca_tpu_torch.io import prefetch as tpf
from genomic_pca_tpu_torch.io import writers as tw
from tests.conftest import make_genotypes


@pytest.fixture
def fileset(tmp_path, rng):
    """A PLINK fileset of 70 SNPs x 37 samples (a partial last byte) with
    5% missing, written by the JAX package's writer."""
    geno = make_genotypes(rng, 70, 37, missing_rate=0.05)
    jbed.write_plink(tmp_path / "toy", geno, bp=list(range(100, 7100, 100)))
    return tmp_path / "toy", geno


@pytest.mark.parametrize("rows,samples", [
    (None, None), (np.array([3, 0, 69, 12]), None),
    (slice(5, 40), np.array([0, 7, 36, 20])),
])
def test_bed_reader_decode_and_packed_reads_match(fileset, rows, samples):
    prefix, geno = fileset
    rj, rt = jbed.BedReader(prefix), tbed.BedReader(prefix)
    assert (rt.n_snps, rt.n_samples) == (rj.n_snps, rj.n_samples) == (70, 37)
    np.testing.assert_array_equal(rt.bim.sid, rj.bim.sid)
    np.testing.assert_array_equal(rt.bim.bp, rj.bim.bp)
    np.testing.assert_array_equal(rt.fam.iid, rj.fam.iid)
    got, ref = rt.read(rows, samples), rj.read(rows, samples)
    assert got.dtype == ref.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    idx = np.arange(70) if rows is None else rows
    np.testing.assert_array_equal(rt.read_packed(idx), rj.read_packed(idx))
    np.testing.assert_array_equal(tbed.pack_bed_rows(geno), jbed.pack_bed_rows(geno))
    if rows is None and samples is None:
        np.testing.assert_array_equal(got, geno)


def test_native_library_is_the_ports_own_build():
    """The copy builds genomic_pca_tpu_torch/native into build/native,
    never the JAX package's native/libplinkio.so."""
    assert tnative._LIB_PATH != jnative._LIB_PATH
    assert tnative._LIB_PATH.endswith("build/native/libplinkio.so")
    assert "genomic_pca_tpu_torch" in tnative._NATIVE_DIR


@pytest.mark.parametrize("text", [
    "chr1 1 5000\n1 5001 9000 tagged\n2\t10\t400\n",
    "1 1 3000\n1 1001 1600\n# comment\n2 0 100000\n",
])
def test_parse_ld_block_file_matches(tmp_path, text):
    path = tmp_path / "blocks.tsv"
    path.write_text(text)
    assert tld.parse_ld_block_file(str(path)) == jld.parse_ld_block_file(str(path))


def test_map_snps_to_blocks_matches(rng):
    chrom = np.array(["1"] * 30 + ["2"] * 20)
    bp = np.concatenate([np.sort(rng.integers(1, 10_000, 30)),
                         np.sort(rng.integers(1, 10_000, 20))])
    parsed = [("1", 1, 5000, "a"), ("1", 2000, 10_000, "b"), ("2", 1, 6000, "c")]
    bt, it = tld.map_snps_to_blocks(chrom, bp, np.arange(50), parsed)
    bj, ij = jld.map_snps_to_blocks(chrom, bp, np.arange(50), parsed)
    np.testing.assert_array_equal(it, ij)
    assert [b.tag for b in bt] == [b.tag for b in bj]
    for x, y in zip(bt, bj):
        np.testing.assert_array_equal(x.pca_snp_ids, y.pca_snp_ids)


def test_writers_give_byte_identical_tsvs(tmp_path, rng):
    names = [f"s{i}" for i in range(13)]
    scores = rng.standard_normal((13, 4)).astype(np.float32)
    sids = [f"rs{i}" for i in range(9)]
    chroms = ["1"] * 5 + ["X"] * 4
    pos = list(range(100, 1000, 100))
    loadings = rng.standard_normal((9, 4)).astype(np.float32)
    mean = rng.uniform(0, 2, 9).astype(np.float32)
    std = rng.uniform(0, 1, 9).astype(np.float32)
    a1, a2 = ["A"] * 9, ["C"] * 9
    for mod, tag in ((jw, "j"), (tw, "t")):
        prefix = str(tmp_path / tag)
        mod.write_principal_components(prefix, names, scores, suffix="vcf.pca.tsv")
        mod.write_eigenvalues(prefix, [3.5, 1.25, 0.5, 0.125])
        mod.write_loadings(prefix, sids, chroms, pos, loadings)
        mod.write_moments(prefix, sids, mean, std, a1, a2)
    for suffix in ("vcf.pca.tsv", "eigenvalues.tsv", "eigensnp.loadings.tsv",
                   "eigensnp.moments.tsv"):
        assert ((tmp_path / f"t.{suffix}").read_bytes()
                == (tmp_path / f"j.{suffix}").read_bytes()), suffix
    ids_t, l_t = tw.read_loadings(str(tmp_path / "j.eigensnp.loadings.tsv"))
    ids_j, l_j = jw.read_loadings(str(tmp_path / "j.eigensnp.loadings.tsv"))
    assert ids_t == ids_j and np.array_equal(l_t, l_j)
    for x, y in zip(tw.read_moments(str(tmp_path / "t.eigensnp.moments.tsv")),
                    jw.read_moments(str(tmp_path / "j.eigensnp.moments.tsv"))):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_strip_prefetcher_order_and_telemetry():
    """Jittered fetch latencies, three workers: both deliver strictly in
    order with the same byte counts."""
    def fetch(i):
        time.sleep(0.001 * ((i * 7) % 3))
        return i * 10, 4

    for mod in (tpf, jpf):
        p = mod.StripPrefetcher(fetch, 40, depth=4, max_workers=3)
        assert list(p) == [i * 10 for i in range(40)]
        assert (p.telemetry.strips_total, p.telemetry.bytes_total) == (40, 160)


def test_bgzf_round_trip_matches(tmp_path, rng):
    data = bytes(rng.integers(0, 4, 300_000, dtype=np.uint8) + ord("0"))
    tbgzf.write_bgzf(tmp_path / "t.gz", data)
    jbgzf.write_bgzf(tmp_path / "j.gz", data)
    assert (tmp_path / "t.gz").read_bytes() == (tmp_path / "j.gz").read_bytes()
    with tbgzf.open_maybe_bgzf(tmp_path / "j.gz") as fh:
        assert fh.read() == data


def test_config_and_errors_match():
    for name in ("DataPrepConfig", "RsvdConfig", "EigenSnpConfig"):
        ct, cj = getattr(tcfg, name), getattr(jcfg, name)
        assert ([(f.name, f.default) for f in dataclasses.fields(ct)]
                == [(f.name, f.default) for f in dataclasses.fields(cj)]), name
    assert tcfg.EigenSnpConfig().subset_size(300_000) == 22_500
    for name in ("BedFormatError", "VcfParseError", "DataPrepError",
                 "ComputeError", "PreflightError"):
        et, ej = getattr(terr, name), getattr(jerr, name)
        assert issubclass(et, terr.GenomicPcaError)
        assert [b.__name__ for b in et.__mro__] == [b.__name__ for b in ej.__mro__]
