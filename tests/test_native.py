"""Native C host-IO vs the numpy fallback: identical framing/packing/emission."""
import os
import pathlib

import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.io import native
from nomalise_kmers_multi_large_tpu.io.pack import InvalidSequenceError, pack_batch
from nomalise_kmers_multi_large_tpu.io.reader import FastxFile

T = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native lib unavailable")
    return lib


def _numpy_cols(f: FastxFile, chunk_bytes: int = 1 << 16):
    from nomalise_kmers_multi_large_tpu.io.reader import RecordColumns

    return RecordColumns.concat(
        list(f._record_blocks_numpy(chunk_bytes))
    )


def test_native_frame_matches_numpy(lib):
    f = FastxFile(str(T / "a1.fastq"), fastq=True)
    ncols = _numpy_cols(f)

    cols, nxt = native.frame(f.data, 0, 4, 10_000)
    assert cols.shape[0] == len(ncols) == 5000
    np.testing.assert_array_equal(cols[:, 0], ncols.rec_start)
    np.testing.assert_array_equal(cols[:, 1], ncols.rec_end)
    np.testing.assert_array_equal(cols[:, 3], ncols.hdr_len)
    np.testing.assert_array_equal(cols[:, 4], ncols.seq_start)
    np.testing.assert_array_equal(cols[:, 5], ncols.seq_len)
    assert nxt == f.size


def test_native_frame_mt_equals_single_thread(lib):
    f = FastxFile(str(T / "a1.fastq"), fastq=True)
    base, nxt1 = native.frame(f.data, 0, 4, 10_000, threads=1)
    for threads in (2, 4, 7):
        cols, nxt = native.frame(f.data, 0, 4, 10_000, threads=threads)
        np.testing.assert_array_equal(cols, base)
        assert nxt == nxt1
    # streaming window: records crossing scan_end wait for the next call
    cols_a, nxt = native.frame(f.data, 0, 4, 10_000, threads=2,
                               scan_end=f.size // 2)
    cols_b, nxt2 = native.frame(f.data, nxt, 4, 10_000, threads=2)
    assert nxt2 == f.size
    np.testing.assert_array_equal(
        np.concatenate([cols_a, cols_b]), base)
    # saturated max_records resumes exactly
    cols_c, nxt3 = native.frame(f.data, 0, 4, 123, threads=2)
    assert cols_c.shape[0] == 123
    np.testing.assert_array_equal(cols_c, base[:123])
    assert nxt3 == base[122, 1]


def test_record_blocks_native_matches_numpy_fasta_and_window_widening(lib):
    # FASTA (2-line records) + chunk window smaller than one record: the
    # native streaming path must widen its scan window and still agree
    f = FastxFile(str(T / "a1.fastq"), fastq=True)
    ncols = _numpy_cols(f)
    from nomalise_kmers_multi_large_tpu.io.reader import RecordColumns

    got = RecordColumns.concat(list(f.record_blocks(chunk_bytes=64)))
    np.testing.assert_array_equal(got.rec_start, ncols.rec_start)
    np.testing.assert_array_equal(got.rec_end, ncols.rec_end)
    np.testing.assert_array_equal(got.seq_start, ncols.seq_start)
    np.testing.assert_array_equal(got.seq_len, ncols.seq_len)


def test_native_frame_no_trailing_newline(lib, tmp_path):
    p = tmp_path / "eof.fastq"
    p.write_bytes(b"@r1\nACGT\n+\nFFFF\n@r2\nTTTT\n+\nFFFF")  # no final \n
    f = FastxFile(str(p), fastq=True)
    ncols = _numpy_cols(f)
    cols, nxt = native.frame(f.data, 0, 4, 10, threads=2)
    assert cols.shape[0] == len(ncols) == 2
    np.testing.assert_array_equal(cols[:, 1], ncols.rec_end)
    np.testing.assert_array_equal(cols[:, 5], ncols.seq_len)
    assert nxt == f.size


def test_native_pack_mt_equals_single_thread(lib):
    f = FastxFile(str(T / "a1.fastq"), fastq=True)
    cols, _ = native.frame(f.data, 0, 4, 5000)
    starts, lens = cols[:, 4], cols[:, 5]
    b1, l1 = native.pack(f.data, starts, lens, 192, 15, threads=1)
    for threads in (2, 5):
        b2, l2 = native.pack(f.data, starts, lens, 192, 15, threads=threads)
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(l1, l2)


def test_native_pack_matches_numpy(lib, monkeypatch):
    f = FastxFile(str(T / "a1.fastq"), fastq=True)
    cols, _ = native.frame(f.data, 0, 4, 1000)
    starts, lens = cols[:, 4], cols[:, 5]
    b1, l1 = native.pack(f.data, starts, lens, 192, 15)
    monkeypatch.setenv("NKML_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    b2, l2 = pack_batch(f.data, starts, lens, 192, 15)
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(l1, l2)


def test_native_pack_rejects_bad_dna(lib, tmp_path):
    p = tmp_path / "bad.fastq"
    p.write_bytes(b"@r\nACGTXACGTACGTACGT\n+\nFFFFFFFFFFFFFFFFF\n")
    f = FastxFile(str(p), fastq=True)
    cols, _ = native.frame(f.data, 0, 4, 10)
    with pytest.raises(InvalidSequenceError):
        native.pack(f.data, cols[:, 4], cols[:, 5], 64, 15)


def test_native_emit_n_rewrite(lib, tmp_path):
    p = tmp_path / "n.fastq"
    p.write_bytes(
        b"@r1\nACGTNNACGTACGTACG\n+\nFFFFFFFFFFFFFFFFF\n"
        b"@r2\nTTTTTTTTTTTTTTTTT\n+\nFFFFFFFFFFFFFFFFF\n"
    )
    f = FastxFile(str(p), fastq=True)
    cols, _ = native.frame(f.data, 0, 4, 10)
    blob = native.emit(f.data, cols, np.array([True, False]))
    assert blob == b"@r1\nACGTAAACGTACGTACG\n+\nFFFFFFFFFFFFFFFFF\n"
    blob2 = native.emit(f.data, cols, np.array([True, True]))
    assert blob2.count(b"@r") == 2
