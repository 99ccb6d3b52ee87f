"""PLINK .bed/.bim/.fam reader and writer, straight into the packed layout
(port of terastructure_tpu/data/bed.py).

PLINK .bed is SNP-major 2-bit with codes

    00 -> homozygous A1 (2 copies of the first/minor allele) -> dosage 2
    01 -> missing                                            -> MISSING
    10 -> heterozygous                                       -> dosage 1
    11 -> homozygous A2                                      -> dosage 0

Our packed layout (data/pack.py) is also SNP-major 2-bit, so ingest is a
single 256-entry byte-LUT translation, no unpack/repack. The LUT maps
every input byte (4 genotypes) to the corresponding output byte.

`native=True` (the default) translates with the C++ core
(terastructure_tpu_torch/native, built at first use; a failed build
raises); `native=False` selects the numpy LUT, its twin. Both give the
reference's bytes. `bed_to_packed_cache` is the out-of-core ingest: the
translated matrix goes to an on-disk cache, an r+ np.memmap, with peak
host memory of about `chunk_bytes`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from terastructure_tpu_torch.data.pack import packed_width

_BED_MAGIC = b"\x6c\x1b"
_SNP_MAJOR = 1

# per-2-bit-code translation: bed -> ours
_CODE_MAP = np.array([2, 3, 1, 0], dtype=np.uint8)


def _byte_lut() -> np.ndarray:
    """256 -> 256 LUT translating a packed PLINK byte to our packed byte."""
    b = np.arange(256, dtype=np.uint16)
    out = np.zeros(256, dtype=np.uint16)
    for s in range(4):
        code = (b >> (2 * s)) & 0x3
        out |= _CODE_MAP[code].astype(np.uint16) << (2 * s)
    return out.astype(np.uint8)


_LUT = _byte_lut()


def _translate(raw: np.ndarray, native: bool) -> np.ndarray:
    """PLINK bytes -> our bytes: the C++ core, or its numpy twin."""
    if native:
        from terastructure_tpu_torch.native import bed_translate

        return bed_translate(raw)
    return _LUT[raw]


def count_lines(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            n += block.count(b"\n")
    return n


def read_fam(path: str):
    """Individual IDs from a .fam file (col 2, per PLINK spec)."""
    ids = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                ids.append(parts[1] if len(parts) > 1 else parts[0])
    return ids


def read_bim(path: str):
    """SNP IDs from a .bim file (col 2)."""
    ids = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                ids.append(parts[1] if len(parts) > 1 else parts[0])
    return ids


def read_bed(
    path: str,
    n: Optional[int] = None,
    l: Optional[int] = None,
    *,
    native: bool = True,
    byte_cols: Optional[tuple[int, int]] = None,
    snp_rows: Optional[tuple[int, int]] = None,
) -> tuple[np.ndarray, Optional[list], Optional[list]]:
    """Read a PLINK .bed (+ sibling .fam/.bim when n/l not given).

    Returns (packed, ind_ids, snp_ids) where packed is uint8
    (l, ceil(n/4)) in our code space, SNP-major, ready for the engine.

    byte_cols=(lo, hi) reads only that byte-column range of every SNP
    row, and snp_rows=(lo, hi) only those rows, via memmap: the
    multi-rank ingest (parallel/multihost.load_bed_shard), where each
    rank loads just its block without touching the rest of a
    biobank-scale file.
    """
    stem, ext = os.path.splitext(path)
    if ext != ".bed":
        raise ValueError(f"expected a .bed path, got {path}")
    ind_ids = snp_ids = None
    if n is None:
        ind_ids = read_fam(stem + ".fam")
        n = len(ind_ids)
    if l is None:
        snp_ids = read_bim(stem + ".bim")
        l = len(snp_ids)

    w_bed = (n + 3) // 4
    with open(path, "rb") as f:
        header = f.read(3)
        if header[:2] != _BED_MAGIC:
            raise ValueError(f"{path}: bad magic {header[:2]!r}; not a PLINK .bed")
        if header[2] != _SNP_MAJOR:
            raise ValueError(
                f"{path}: individual-major .bed not supported (mode {header[2]})"
            )
    expected = l * w_bed
    size = os.path.getsize(path) - 3
    if size != expected:
        raise ValueError(
            f"{path}: size mismatch, got {size} genotype bytes, "
            f"expected {expected} for n={n} l={l}"
        )
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=3,
                   shape=(l, w_bed))
    if snp_rows is not None:
        mm = mm[snp_rows[0]:snp_rows[1]]
    if byte_cols is not None:
        lo, hi = byte_cols
        raw = np.ascontiguousarray(mm[:, lo:hi])
        last = hi >= w_bed
    else:
        raw = np.asarray(mm)
        last = True

    out = _translate(raw, native)
    if last:
        out = _fix_padding(out, n)
    return out, ind_ids, snp_ids


def bed_to_packed_cache(
    path: str,
    cache_path: str,
    n: Optional[int] = None,
    l: Optional[int] = None,
    *,
    native: bool = True,
    chunk_bytes: int = 1 << 28,
) -> tuple[np.ndarray, Optional[list], Optional[list]]:
    """Translate a PLINK .bed into an on-disk packed cache, chunked.

    The out-of-core ingest path (svi/stream.py): when even the packed
    matrix (n*l/4 bytes — 250 GB at 1M x 1M) exceeds host RAM, the
    translated codes go straight to a disk file and come back as a
    writable np.memmap; peak host memory stays at ~chunk_bytes. The
    cache is our code space, so GenotypeData.from_packed can carve eval
    sets on it in place (writes go to the cache file, never the .bed).

    Returns (packed r+ memmap (l, ceil(n/4)), ind_ids, snp_ids).
    """
    stem, ext = os.path.splitext(path)
    if ext != ".bed":
        raise ValueError(f"expected a .bed path, got {path}")
    ind_ids = snp_ids = None
    if n is None:
        ind_ids = read_fam(stem + ".fam")
        n = len(ind_ids)
    if l is None:
        snp_ids = read_bim(stem + ".bim")
        l = len(snp_ids)
    w_bed = (n + 3) // 4
    with open(path, "rb") as f:
        header = f.read(3)
        if header[:2] != _BED_MAGIC:
            raise ValueError(f"{path}: bad magic; not a PLINK .bed")
        if header[2] != _SNP_MAJOR:
            raise ValueError(f"{path}: individual-major .bed not supported")
    size = os.path.getsize(path) - 3
    if size != l * w_bed:
        raise ValueError(f"{path}: size mismatch for n={n} l={l}")

    src = np.memmap(path, dtype=np.uint8, mode="r", offset=3,
                    shape=(l, w_bed))
    dst = np.lib.format.open_memmap(
        cache_path, mode="w+", dtype=np.uint8, shape=(l, w_bed))
    rows_per_chunk = max(chunk_bytes // max(w_bed, 1), 1)
    for lo in range(0, l, rows_per_chunk):
        hi = min(lo + rows_per_chunk, l)
        raw = np.ascontiguousarray(src[lo:hi])
        out = _translate(raw, native)
        dst[lo:hi] = _fix_padding(out, n)
    dst.flush()
    return dst, ind_ids, snp_ids


def read_bed_rows(path: str, n: int, l: int, rows: np.ndarray,
                  *, native: bool = True) -> np.ndarray:
    """Gather specific SNP rows (full width) from a .bed via memmap.

    The multi-host loader's way (the reference's
    parallel/multihost.load_bed_shard) to give every host the complete
    genotype columns of the eval-SNP pool without reading the rest of
    the file. Returns uint8 (len(rows), W) in our code space.
    """
    w_bed = (n + 3) // 4
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=3,
                   shape=(l, w_bed))
    raw = np.ascontiguousarray(mm[np.asarray(rows)])
    out = _translate(raw, native)
    return _fix_padding(out, n)


def _fix_padding(packed: np.ndarray, n: int) -> np.ndarray:
    """Force tail padding positions (beyond n) to MISSING (code 3).

    PLINK pads trailing bits with 0 (which maps to dosage 2 in our code
    space); the engine requires padding to decode as MISSING.
    """
    rem = n % 4
    if rem and packed.shape[1]:
        # keep the low 2*rem bits, set the rest to 1s (3 = 0b11 each)
        keep_mask = np.uint8((1 << (2 * rem)) - 1)
        fill = np.uint8(0xFF & ~keep_mask)
        packed[:, -1] = (packed[:, -1] & keep_mask) | fill
    return packed


def write_bed(path: str, packed: np.ndarray, n: int) -> None:
    """Write our packed matrix as a PLINK .bed (inverse code map).

    Used by the simulator/CLI so outputs interoperate with PLINK tooling.
    """
    inv = np.array([3, 2, 0, 1], dtype=np.uint8)  # ours -> bed code
    b = np.arange(256, dtype=np.uint16)
    lut = np.zeros(256, dtype=np.uint16)
    for s in range(4):
        code = (b >> (2 * s)) & 0x3
        lut |= inv[code].astype(np.uint16) << (2 * s)
    lut = lut.astype(np.uint8)
    w_bed = packed_width(n)
    assert packed.shape[1] == w_bed
    with open(path, "wb") as f:
        f.write(_BED_MAGIC + bytes([_SNP_MAJOR]))
        lut[packed].tofile(f)


def write_fam(path: str, ids) -> None:
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{i} {i} 0 0 0 -9\n")


def write_bim(path: str, ids) -> None:
    with open(path, "w") as f:
        for j, s in enumerate(ids):
            f.write(f"1 {s} 0 {j + 1} A B\n")


def read_text_genotypes(path: str, *, snp_major: bool = True,
                        missing_codes=(9, -1)) -> np.ndarray:
    """Whitespace-separated 0/1/2 text genotypes -> dense int8 (N, L).

    The reference also accepts a text matrix (SURVEY.md §2.1 [MED]);
    rows are SNPs when snp_major (reference convention), individuals
    otherwise. Codes in `missing_codes` become MISSING.
    """
    mat = np.loadtxt(path, dtype=np.int16)
    if mat.ndim == 1:
        mat = mat[None, :]
    for mc in missing_codes:
        mat[mat == mc] = 3
    if not np.isin(mat, (0, 1, 2, 3)).all():
        bad = np.unique(mat[~np.isin(mat, (0, 1, 2, 3))])
        raise ValueError(f"{path}: unexpected genotype codes {bad}")
    x = mat.astype(np.int8)
    return x.T if snp_major else x
