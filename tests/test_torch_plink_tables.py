"""The port's .bim / .fam readers: the native pass (io/native.py
`parse_table_native`) against the Python line loop it falls back to and
the JAX package's readers, and what the native pass hands over to the
loop."""

from pathlib import Path

import numpy as np
import pytest

from genomic_pca_tpu.io import bed as jbed
from genomic_pca_tpu_torch.errors import BedFormatError
from genomic_pca_tpu_torch.io import bed as tbed
from genomic_pca_tpu_torch.io import native as tnative
from genomic_pca_tpu_torch.utils import profiling

BIM_FIELDS = ("chrom", "sid", "bp", "a1", "a2")
FAM_FIELDS = ("fid", "iid")

# Each text is read as a .bim and as a .fam (its first two columns).
ACCEPTED = {
    "tabs": "1\trs1\t0\t100\tA\tG\n1\trs2\t0.25\t200\tC\tT\n",
    "runs_of_spaces": "1   rs1  0 100    A G\n  2 rs2 0.5 300 T   C  \n",
    "crlf": "1 rs1 0 100 A G\r\n1 rs2 0 200 C T\r\n22 rs3 0 300 G A\r\n",
    "blank_lines": "\n1 rs1 0 100 A G\n\n   \t \n1 rs2 0 200 C T\n\r\n\n",
    "more_than_six_columns": "1 rs1 0 100 A G extra more\n1 rs2 0 200 C T x\n",
    "negative_and_zero_bp": ("1 rs1 0 -5 A G\n1 rs2 0 0 C T\n1 rs3 0 -0 G A\n"
                             "1 rs4 0 007 A C\n1 rs5 0 -9223372036854775808 A C\n"
                             "1 rs6 0 9223372036854775807 A C\n"),
    "multi_character_alleles": ("1 rs1 0 100 AT G\n1 rs2 0 200 C TTTG\n"
                                "1 rs3 0 300 <DEL> .\n1 rs4 0 400 AT G\n"),
    "interleaved_chromosomes": ("1 a 0 1 A G\nchr2 b 0 2 A G\nX c 0 3 A G\n1 d 0 4 G A\n"
                                "MT e 0 5 A G\nchr2 f 0 6 A G\nX g 0 7 T C\n"),
    "no_trailing_newline": "1 rs1 0 100 A G\n1 rs2 0 200 C T",
    "empty": "",
}

# The native pass hands each of these to the loop, which accepts or raises.
HANDED_OVER = {
    "five_fields": "1 rs1 0 100 A G\n1 rs2 0 200 C\n",
    "bp_12a": "1 rs1 0 12a A G\n",
    "bp_plus_5": "1 rs1 0 +5 A G\n1 rs2 0 6 A G\n",
    "bp_past_int64": "1 rs1 0 99999999999999999999 A G\n",
    "bp_underscore": "1 rs1 0 1_000 A G\n",
    "non_ascii_sid": "1 rsé1 0 100 A G\n1 rs2 0 200 C T\n",
    "lone_cr": "1 rs1 0 100 A G\r1 rs2 0 200 C T\n",
    "vertical_tab": "1 rs1\x0b0 100 A G\n",
    "fam_one_field": "S1 S1 0 0 0 -9\nS2\n",
}


@pytest.fixture(autouse=True)
def native_library():
    if tnative.get_lib() is None:
        pytest.skip("the native library does not build here (no make / g++)")


def _write(tmp_path, text, suffix):
    path = tmp_path / f"t.{suffix}"
    path.write_bytes(text.encode("utf-8"))
    return str(path)


def _columns(table, fields):
    return [getattr(table, f) for f in fields]


def _outcome(reader, path, fields):
    """(columns, None) or (None, (exception type, message)), and the
    counts of the rows each path parsed."""
    profiling.reset_counts()
    try:
        out = _columns(reader(path), fields), None
    except Exception as e:  # the loop's own errors, compared by type and text
        out = None, (type(e), str(e))
    return out, (profiling.COUNTS["table_rows_native"], profiling.COUNTS["table_rows_loop"])


def _assert_same(got, ref):
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tolist() == y.tolist()
        assert [type(v) for v in x.tolist()] == [type(v) for v in y.tolist()]


@pytest.mark.parametrize("suffix", ["bim", "fam"])
@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_native_pass_equals_the_loop_and_the_jax_reader(tmp_path, monkeypatch, case, suffix):
    text = ACCEPTED[case]
    path = _write(tmp_path, text, suffix)
    reader, jreader, fields = ((tbed.read_bim, jbed.read_bim, BIM_FIELDS) if suffix == "bim"
                               else (tbed.read_fam, jbed.read_fam, FAM_FIELDS))
    n_rows = sum(1 for line in text.splitlines() if line.split())
    (native_cols, err), counts = _outcome(reader, path, fields)
    assert err is None and counts == (n_rows, 0)
    with monkeypatch.context() as m:
        m.setattr(tnative, "get_lib", lambda: None)
        (loop_cols, err), counts = _outcome(reader, path, fields)
    assert err is None and counts == (0, n_rows)
    _assert_same(native_cols, loop_cols)
    jax_cols = _columns(jreader(path), fields)
    for x, y in zip(native_cols, jax_cols):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    if suffix == "bim":
        assert native_cols[2].dtype == np.int64
        assert all(type(v) is str for c in native_cols[:2] + native_cols[3:] for v in c)


@pytest.mark.parametrize("case", sorted(HANDED_OVER))
def test_native_pass_hands_over_what_the_loop_must_judge(tmp_path, monkeypatch, case):
    suffix = "fam" if case.startswith("fam_") else "bim"
    reader, fields = ((tbed.read_fam, FAM_FIELDS) if suffix == "fam"
                      else (tbed.read_bim, BIM_FIELDS))
    path = _write(tmp_path, HANDED_OVER[case], suffix)
    (cols, err), counts = _outcome(reader, path, fields)
    with monkeypatch.context() as m:
        m.setattr(tnative, "get_lib", lambda: None)
        (loop_cols, loop_err), loop_counts = _outcome(reader, path, fields)
    assert counts == loop_counts
    assert counts[0] == 0
    assert err == loop_err
    if loop_err is None:
        assert counts[1] == len(loop_cols[0]) > 0
        _assert_same(cols, loop_cols)
    if case in ("five_fields", "fam_one_field"):
        assert err[0] is BedFormatError
    if case == "bp_12a":
        assert err[0] is ValueError
    if case == "bp_past_int64":
        assert err[0] is OverflowError


def test_native_pass_across_threads_merges_chunks(tmp_path, rng):
    """A table of several 64 KiB chunks, parsed on up to seven threads, whose
    chromosomes and alleles first appear in later chunks, so that their
    codes are remapped across chunks; mixed line ends and separators."""
    n = 12_000
    chroms = np.array(["1", "2", "chr3", "X", "MT", "10", "chr22"])
    alleles = np.array(["A", "C", "G", "T", "AT", "CTT", "GA", "<INS>"])
    ch = chroms[np.minimum(rng.integers(0, 3, n) + (np.arange(n) * 7) // n, 6)]
    a1 = alleles[np.minimum(rng.integers(0, 4, n) + (np.arange(n) * 8) // n, 7)]
    a2 = alleles[rng.integers(0, 8, n)]
    bp = rng.integers(-10**12, 10**12, n)
    seps = np.array(["\t", " ", "  \t "])[rng.integers(0, 3, n)]
    ends = np.array(["\n", "\r\n", "\n\n"])[rng.integers(0, 3, n)]
    text = "".join(f"{c}{s}rs{i}{s}0{s}{b}{s}{x}{s}{y}{e}"
                   for i, (c, s, b, x, y, e) in enumerate(zip(ch, seps, bp, a1, a2, ends)))
    assert len(text) > 4 * 65536
    path = _write(tmp_path, text, "bim")
    data = Path(path).read_bytes()
    ref = tbed._bim_loop(path)
    for threads in (1, 2, 7):
        got = tnative.parse_table_native(data, tbed._BIM_KINDS, n_threads=threads)
        _assert_same(got, ref)
    profiling.reset_counts()
    _assert_same(_columns(tbed.read_bim(path), BIM_FIELDS), ref)
    assert profiling.COUNTS["table_rows_native"] == n
