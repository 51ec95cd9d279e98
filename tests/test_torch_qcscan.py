"""The port's device QC scan and its QC->matrix capture fusion, on the CPU.

`ops/qc.py` `genotype_counts` / `genotype_counts_packed` against the JAX
reductions on the same seeded strips (exactly: integer counts); the
device-scan `prepare_data` against the JAX `prepare_data(...,
qc_mode="device")` (keep, mean and std bit for bit); the container the
capture assembles against the one the port builds by re-reading the BED
(geno, mean, inv_std and the row count bit for bit), packed, dense and
under a keep-list; and the 45% capture budget (tests/test_eigensnp.py
:328-420 for the JAX package).
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.models import prepare as jprep
from genomic_pca_tpu.ops import qc as jqc
from genomic_pca_tpu_torch.models import prepare as tprep
from genomic_pca_tpu_torch.ops import qc as tqc
from genomic_pca_tpu_torch.parallel.sharded import (
    dense_cols, pack_int8_rows, packed_cols,
)
from tests.conftest import make_genotypes
from tests.test_eigensnp import _setup


def _strip(rng, rows, n):
    """Seeded dosages with 10% missing and two all-missing rows."""
    g = make_genotypes(rng, rows, n, missing_rate=0.1)
    g[[1, rows - 1]] = -127
    return g


@pytest.mark.parametrize("n", [37, 40, 129, 1001])
def test_genotype_counts_match_reference(rng, n):
    """Ragged sample counts (n mod 4 != 0) and all-missing rows: the int8
    counts over a -127-padded strip, the packed counts over sanitized
    bytes padded with 0x55 (the scan's layouts), equal to the JAX
    functions' exactly."""
    g = _strip(rng, 50, n)
    dense = np.full((50, dense_cols(n)), -127, np.int8)
    dense[:, :n] = g
    got = torch.stack(tqc.genotype_counts(torch.from_numpy(dense))).numpy()
    ref = np.stack([np.asarray(c) for c in jqc.genotype_counts(jnp.asarray(dense))])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    packed = np.full((50, packed_cols(n)), 0x55, np.uint8)
    raw = pack_int8_rows(g)
    packed[:, : raw.shape[1]] = raw
    got_p = torch.stack(tqc.genotype_counts_packed(torch.from_numpy(packed), n)).numpy()
    ref_p = np.stack([np.asarray(c) for c in
                      jqc.genotype_counts_packed(jnp.asarray(packed), n)])
    assert got_p.dtype == np.int32
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_p, got)
    assert (got[3, [1, 49]] == 0).all()


def test_packed_counts_mask_unsanitized_trailing_fields(rng):
    """PLINK zero-fills the last byte's trailing fields (code 00, dosage
    2): the mask keeps them out, as the JAX function's does."""
    g = _strip(rng, 20, 37)
    from genomic_pca_tpu_torch.io.bed import pack_bed_rows

    packed = pack_bed_rows(g)  # trailing fields 00
    got = torch.stack(tqc.genotype_counts_packed(torch.from_numpy(packed), 37)).numpy()
    ref = np.stack([np.asarray(c) for c in
                    jqc.genotype_counts_packed(jnp.asarray(packed), 37)])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.T, tqc.genotype_counts_int8_host(g))


def test_qc_strip_matches_reference(rng, tmp_path):
    _, _, cfg = _setup(tmp_path, rng, n_snps=60, n_samples=40)
    g = _strip(rng, 60, 40)
    got = tqc.qc_strip(torch.from_numpy(g), 40, cfg)
    ref = jqc.qc_strip(g, 40, cfg)
    for key in ("keep", "mean", "std"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))


def _cfg(tmp_path, rng, keep_list, **kw):
    _, _, cfg = _setup(tmp_path, rng, n_snps=450, n_samples=41, missing_rate=0.05)
    cfg = dataclasses.replace(cfg, qc_device_batch=200, **kw)
    if keep_list:
        keep = tmp_path / "keep.txt"
        keep.write_text("".join(f"sample{i}\n" for i in range(0, 41, 3)))
        cfg = dataclasses.replace(cfg, sample_keep_path=str(keep))
    return cfg


@pytest.mark.parametrize("keep_list", [False, True])
@pytest.mark.parametrize("packed_pipeline", [True, False])
def test_device_scan_matches_reference(tmp_path, rng, keep_list, packed_pipeline):
    """keep / mean / std of the device scan equal the JAX device scan's
    and the port's host scan's bit for bit."""
    cfg = _cfg(tmp_path, rng, keep_list, qc_mode="device",
               packed_pipeline=packed_pipeline)
    pt = tprep.prepare_data(cfg, device="cpu")
    pj = jprep.prepare_data(cfg)
    ph = tprep.prepare_data(dataclasses.replace(cfg, qc_mode="host"))
    for p in (pj, ph):
        np.testing.assert_array_equal(pt.pca_snp_orig_indices, p.pca_snp_orig_indices)
        for key in ("mean", "std"):
            assert getattr(pt, key).dtype == getattr(p, key).dtype
            np.testing.assert_array_equal(getattr(pt, key), getattr(p, key))
    assert pt.n_snps_post_qc == pj.n_snps_post_qc
    assert pt.qc_capture.packed == (packed_pipeline and not keep_list)
    assert len(pt.qc_capture.batches) == 3  # 450 rows in batches of 200


@pytest.mark.parametrize("keep_list", [False, True])
@pytest.mark.parametrize("packed_pipeline", [True, False])
def test_capture_container_is_the_reread_one(tmp_path, rng, caplog, keep_list,
                                             packed_pipeline):
    """The container gathered from the captured batches is the one
    `load_matrix` builds by re-reading the BED, bit for bit; the capture
    is released once assembled.  Under a keep-list with the packed
    pipeline the int8 batches are repacked on the device."""
    cfg = _cfg(tmp_path, rng, keep_list, qc_mode="device",
               packed_pipeline=packed_pipeline)
    with caplog.at_level(logging.INFO, logger="genomic_pca_tpu_torch"):
        fused = tprep.prepare_data(cfg, device="cpu")
        sm_f = fused.load_matrix("cpu")
    assert "no BED re-read" in caplog.text
    assert fused.qc_capture is None
    reread = tprep.prepare_data(dataclasses.replace(cfg, fuse_qc_matrix=False),
                                device="cpu")
    assert reread.qc_capture is None
    sm_r = reread.load_matrix("cpu")
    assert sm_f.packed == sm_r.packed == packed_pipeline
    assert (sm_f.n_rows, sm_f.d_pad) == (sm_r.n_rows, sm_r.d_pad)
    for key in ("geno", "mean", "inv_std"):
        got, want = getattr(sm_f, key), getattr(sm_r, key)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=key)


def test_auto_dense_takes_the_capture_as_the_reference(tmp_path, rng):
    """`qc_mode="auto"` with `packed_pipeline=False`: the device scan and
    the capture, as in the JAX package; its container equals the JAX
    capture container."""
    cfg = dataclasses.replace(_cfg(tmp_path, rng, False), packed_pipeline=False)
    pt, pj = tprep.prepare_data(cfg, device="cpu"), jprep.prepare_data(cfg)
    assert pt.qc_capture is not None and pj.qc_capture is not None
    sm_t, sm_j = pt.load_matrix("cpu"), pj.load_matrix()
    d = pt.n_pca_snps
    np.testing.assert_array_equal(sm_t.geno.numpy(), np.asarray(sm_j.geno)[:d])
    np.testing.assert_array_equal(sm_t.inv_std.numpy(), np.asarray(sm_j.inv_std)[:d])


def test_capture_skipped_over_the_budget(tmp_path, rng, monkeypatch, caplog):
    """Past 45% of the device budget the scan keeps no batch (logged) and
    `load_matrix` re-reads the BED; the JAX rule at the same budget makes
    the same decision."""
    cfg = _cfg(tmp_path, rng, False, qc_mode="device")
    need = 450 * packed_cols(41)
    for budget, want in ((int(need / 0.45) + 1, True), (int(need / 0.45) - 1, False)):
        monkeypatch.setattr(tprep, "device_memory_budget", lambda device, b=budget: b)
        monkeypatch.setattr(jprep, "_default_device_budget", lambda b=budget: b)
        with caplog.at_level(logging.INFO, logger="genomic_pca_tpu_torch"):
            caplog.clear()
            prep = tprep.prepare_data(cfg, device="cpu")
        assert (prep.qc_capture is not None) is want
        assert (jprep.prepare_data(cfg).qc_capture is not None) is want
        assert ("capture skipped" in caplog.text) is not want
    monkeypatch.setattr(tprep, "device_memory_budget", lambda device: 1 << 40)
    sm = prep.load_matrix("cpu")
    assert sm.n_rows == prep.n_pca_snps and prep.qc_capture is None


def test_will_stream_drops_the_capture(tmp_path, rng, monkeypatch):
    """A container that streams never reads the capture: `load_matrix`
    releases it (the JAX rule, genomic_pca_tpu/models/prepare.py:735)."""
    cfg = _cfg(tmp_path, rng, False, qc_mode="device")
    prep = tprep.prepare_data(cfg, device="cpu")
    assert prep.qc_capture is not None
    monkeypatch.setattr(tprep, "device_memory_budget", lambda device: 1024)
    sm = prep.load_matrix("cpu", strip_size=64)
    assert not sm.resident and prep.qc_capture is None


def test_device_scan_missing_policy_error(tmp_path, rng):
    """`missing_policy="error"` holds on the captured container too."""
    from genomic_pca_tpu_torch.errors import DataPrepError

    cfg = _cfg(tmp_path, rng, False, qc_mode="device", missing_policy="error")
    with pytest.raises(DataPrepError, match="missing_policy"):
        tprep.prepare_data(cfg, device="cpu").load_matrix("cpu")
