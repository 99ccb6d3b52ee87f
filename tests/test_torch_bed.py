"""The port's PLINK ingest (data/bed.py, GenotypeData.from_bed) and its
native core (native/bedops.cpp) against the reference's, byte for byte
on the same numpy inputs (CPU)."""

import numpy as np
import pytest

from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import bed as ref_bed
from terastructure_tpu.data import pack as ref_pack
from terastructure_tpu_torch import native
from terastructure_tpu_torch.data import GenotypeData, bed, pack


def _write(tmp_path, packed, n, stem="t", module=bed):
    """A .bed/.fam/.bim triple of `packed` written by `module`."""
    path = str(tmp_path / f"{stem}.bed")
    l = packed.shape[0]
    module.write_bed(path, packed, n)
    module.write_fam(str(tmp_path / f"{stem}.fam"),
                     [f"i{i}" for i in range(n)])
    module.write_bim(str(tmp_path / f"{stem}.bim"),
                     [f"s{j}" for j in range(l)])
    return path


def _packed(n, l, seed, missing=0.03):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, size=(l, n)).astype(np.int8)
    x[rng.random((l, n)) < missing] = 3
    return ref_pack.pack2bit(x)


def _same_sets(a, b):
    for x, y in ((a.validation, b.validation), (a.heldout, b.heldout)):
        assert len(x) == len(y) > 0
        for f in ("ind_idx", "snp_idx", "x"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


# ---- native core: its numpy twins and the reference's ---------------------

def test_native_pack_and_unpack_match_numpy():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, size=(64, 37)).astype(np.int8)
    p = native.pack2bit(x)
    np.testing.assert_array_equal(p, pack.pack2bit(x))
    np.testing.assert_array_equal(p, ref_pack.pack2bit(x))
    np.testing.assert_array_equal(native.unpack2bit(p, 37), x)
    np.testing.assert_array_equal(native.unpack2bit(p, 37),
                                  pack.unpack2bit(p, 37))
    assert (native.unpack2bit(p, 4 * p.shape[1])[:, 37:] == 3).all()
    with pytest.raises(ValueError, match="exceeds capacity"):
        native.unpack2bit(np.zeros((2, 3), np.uint8), 13)


def test_native_bed_translate_matches_lut():
    raw = np.random.default_rng(2).integers(0, 256, size=(40, 13),
                                            dtype=np.uint8)
    got = native.bed_translate(raw)
    np.testing.assert_array_equal(got, bed._LUT[raw])
    np.testing.assert_array_equal(got, ref_bed._LUT[raw])
    np.testing.assert_array_equal(native.bed_translate(got, inverse=True),
                                  raw)


@pytest.mark.parametrize("wp", [13, 16])
def test_native_gather_groups_matches_numpy(wp):
    rng = np.random.default_rng(0)
    l, w, g = 37, 13, 4
    packed = rng.integers(0, 256, size=(l, w), dtype=np.uint8)
    starts = np.array([0, 5, 34, 36, 12, 35])          # 34..36 wrap at L
    out = np.full((len(starts) * g, wp), 0xAB, dtype=np.uint8)
    native.gather_groups(packed, starts, g, out)
    want = np.stack([packed[(s + r) % l] for s in starts for r in range(g)])
    np.testing.assert_array_equal(out[:, :w], want)
    assert (out[:, w:] == 0xAB).all()                  # padding untouched
    with pytest.raises(ValueError, match="out of range"):
        native.gather_groups(packed, np.array([l]), g, out[:g])


def test_native_matches_the_reference_native():
    ref_native = pytest.importorskip("terastructure_tpu.native")
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(33, 17), dtype=np.uint8)
    np.testing.assert_array_equal(native.bed_translate(raw),
                                  ref_native.bed_translate(raw))
    x = rng.integers(0, 4, size=(9, 61)).astype(np.int8)
    np.testing.assert_array_equal(native.pack2bit(x), ref_native.pack2bit(x))
    assert "terastructure_tpu_torch" in str(native.library_path())


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; nothing
    falls back to numpy."""
    bad = tmp_path / "bedops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


# ---- .bed I/O ------------------------------------------------------------

@pytest.mark.parametrize("native_", [True, False])
def test_bed_io_matches_reference_at_ragged_n(tmp_path, native_):
    """write_bed, read_bed (whole and byte_cols), read_bed_rows and the
    cache at n = 57 (a partial last byte): the reference's bytes."""
    n, l = 57, 80
    packed = _packed(n, l, seed=3)
    path = _write(tmp_path, packed, n)
    ref_path = _write(tmp_path, packed, n, stem="r", module=ref_bed)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    for f in (".fam", ".bim"):
        assert (open(path[:-4] + f).read()
                == open(ref_path[:-4] + f).read())

    got, ind_ids, snp_ids = bed.read_bed(path, native=native_)
    want, ref_ind, ref_snp = ref_bed.read_bed(path, native=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, packed)
    assert ind_ids == ref_ind and snp_ids == ref_snp and len(ind_ids) == n
    for cols in ((0, 5), (5, 15)):
        np.testing.assert_array_equal(
            bed.read_bed(path, native=native_, byte_cols=cols)[0],
            ref_bed.read_bed(path, native=False, byte_cols=cols)[0])
    rows = np.array([3, 0, 79, 3])
    np.testing.assert_array_equal(
        bed.read_bed_rows(path, n, l, rows, native=native_),
        ref_bed.read_bed_rows(path, n, l, rows, native=False))

    cache, c_ind, c_snp = bed.bed_to_packed_cache(
        path, str(tmp_path / "t.cache.npy"), native=native_,
        chunk_bytes=256)                                 # many chunks
    ref_cache, _, _ = ref_bed.bed_to_packed_cache(
        path, str(tmp_path / "r.cache.npy"), native=False, chunk_bytes=256)
    assert isinstance(cache, np.memmap)
    np.testing.assert_array_equal(np.asarray(cache), np.asarray(ref_cache))
    assert (open(tmp_path / "t.cache.npy", "rb").read()
            == open(tmp_path / "r.cache.npy", "rb").read())
    assert c_ind == ref_ind and c_snp == ref_snp


def test_carve_on_the_cache_is_the_reference_carve(tmp_path):
    """The carve on the memmap cache draws the reference's sets, writes
    through to the cache file and leaves the .bed untouched."""
    n, l = 57, 80
    path = _write(tmp_path, _packed(n, l, seed=5), n)
    before = open(path, "rb").read()
    cache, _, _ = bed.bed_to_packed_cache(path, str(tmp_path / "c.npy"))
    ref_cache, _, _ = ref_bed.bed_to_packed_cache(path,
                                                  str(tmp_path / "rc.npy"))
    split = dict(seed=1, validation_frac=0.02, heldout_frac=0.02)
    data = GenotypeData.from_packed(cache, n, **split)
    ref = RefData.from_packed(np.asarray(ref_cache), n, **split)
    assert isinstance(data.packed, np.memmap)
    _same_sets(data, ref)
    np.testing.assert_array_equal(data.packed, ref.packed)
    data.packed.flush()
    reread = np.load(str(tmp_path / "c.npy"), mmap_mode="r")
    np.testing.assert_array_equal(reread, ref.packed)
    assert open(path, "rb").read() == before


def test_from_bed_matches_reference(tmp_path):
    n, l = 101, 300
    path = _write(tmp_path, _packed(n, l, seed=6), n)
    kw = dict(seed=4, validation_frac=0.02, heldout_frac=0.02,
              eval_snp_pool=50)
    data = GenotypeData.from_bed(path, **kw)
    ref = RefData.from_bed(path, **kw)
    assert (data.n, data.l) == (ref.n, ref.l) == (n, l)
    np.testing.assert_array_equal(data.packed, ref.packed)
    _same_sets(data, ref)
    assert data.ind_ids == ref.ind_ids and data.snp_ids == ref.snp_ids
    assert len(np.unique(data.validation.snp_idx)) <= 50


def test_ids_pass_through_from_dense():
    x = np.random.default_rng(7).integers(0, 3, (16, 40)).astype(np.int8)
    ids = [f"i{i}" for i in range(16)]
    data = GenotypeData.from_dense(x, ind_ids=ids, snp_ids=list("ab"),
                                   validation_frac=0.0, heldout_frac=0.0)
    assert data.ind_ids == ids and data.snp_ids == ["a", "b"]


def test_read_text_genotypes_matches_reference(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("0 1 2 9\n2 -1 1 0\n1 1 0 2\n")
    for snp_major in (True, False):
        np.testing.assert_array_equal(
            bed.read_text_genotypes(str(path), snp_major=snp_major),
            ref_bed.read_text_genotypes(str(path), snp_major=snp_major))
    path.write_text("0 5\n")
    with pytest.raises(ValueError, match="unexpected genotype codes"):
        bed.read_text_genotypes(str(path))


def test_bad_bed_files_raise(tmp_path):
    n, l = 8, 4
    path = _write(tmp_path, _packed(n, l, seed=8), n)
    raw = open(path, "rb").read()
    open(path, "wb").write(b"\x00\x00\x01" + raw[3:])
    with pytest.raises(ValueError, match="bad magic"):
        bed.read_bed(path)
    open(path, "wb").write(raw[:3] + raw[3:-1])
    with pytest.raises(ValueError, match="size mismatch"):
        bed.bed_to_packed_cache(path, str(tmp_path / "c.npy"))
    with pytest.raises(ValueError, match="expected a .bed"):
        bed.read_bed(str(tmp_path / "t.fam"))
