"""Genotype dataset container + eval-set carve (port of
terastructure_tpu/data/dataset.py).

Training genotypes live 2-bit packed, SNP-major: uint8 (L, ceil(N/4)).
Validation and heldout entries are re-coded MISSING in the training
matrix and kept as COO (ind_idx, snp_idx, x) arrays for scoring. All of
this is host numpy and draws the same split as the reference for the
same seed, so both packages fit and score the same data. The carve works
on an np.memmap as on an array (`from_bed`, or `from_packed` on the cache
of data/bed.bed_to_packed_cache): its lookups read the touched bytes and
its recode writes them back to the mapped file.

A rank of a multi-card fit holds a block of the matrix (byte_col_offset,
snp_row_offset) and the full-width rows of the eval-SNP pool
(eval_rows_full). A matrix simulated on the card
(data/simulate.simulate_packed_device_resident) is carved there by
`carve_eval_device`: the lookups run on the device and only the entry
arrays cross to the host; its GenotypeData holds the device tensor as
`packed` and the pool's rows as `eval_rows_full`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from terastructure_tpu_torch.data.pack import pack2bit, packed_width
from terastructure_tpu_torch.models.psd import MISSING

log = logging.getLogger("terastructure_tpu_torch")

# per-byte count of 2-bit codes equal to MISSING (0b11)
_MISS_LUT = np.array(
    [sum(((b >> (2 * s)) & 3) == MISSING for s in range(4))
     for b in range(256)], dtype=np.uint8)


@dataclasses.dataclass
class EntrySet:
    """A COO set of (individual, SNP, genotype) entries."""

    ind_idx: np.ndarray   # (M,) int32
    snp_idx: np.ndarray   # (M,) int32
    x: np.ndarray         # (M,) int8 in {0,1,2}

    def __len__(self):
        return len(self.x)


def _lookup_packed(packed: np.ndarray, i: np.ndarray, j: np.ndarray):
    """Genotype codes at entries (i, j) of the packed (L, W) matrix."""
    byte = packed[j, i >> 2]
    shift = (2 * (i & 3)).astype(np.uint8)
    return ((byte >> shift) & 3).astype(np.int8)


def _recode_missing_packed(packed: np.ndarray, i: np.ndarray, j: np.ndarray):
    """Set entries (i, j) to MISSING in place (MISSING = 0b11: OR mask)."""
    shift = (2 * (i & 3)).astype(np.uint8)
    np.bitwise_or.at(packed, (j, i >> 2), np.uint8(3) << shift)


def _missing_rate(packed: np.ndarray, n: int, l: int,
                  rng: np.random.Generator) -> float:
    """Fraction of MISSING among the n*l real entries: exact by a per-byte
    popcount when the matrix is small, a sampled estimate otherwise."""
    if packed.size <= (1 << 24):
        total_missing = int(_MISS_LUT[packed].sum())
        pad = (4 * packed.shape[1] - n) * l      # padding codes are MISSING
        return max(total_missing - pad, 0) / max(n * l, 1)
    probe = 1 << 20
    pi = rng.integers(0, n, size=probe)
    pj = rng.integers(0, l, size=probe)
    return float((_lookup_packed(packed, pi, pj) == MISSING).mean())


def _sample_entries(lookup, n: int, l: int, n_val: int, n_held: int,
                    rng: np.random.Generator, pool, miss_rate: float):
    """Distinct non-missing entries for the eval sets, in the reference's
    draws: rejection sampling of (individual, SNP) candidates (the SNPs
    from `pool` where given) against lookup(i, j), the genotype codes,
    until rounds stop finding new entries (then truncated, with a
    warning), shuffled. Returns (obs_i, obs_j, n_val, n_held)."""
    want = n_val + n_held
    ii = np.empty(0, np.int64)
    stall = 0
    while len(ii) < want and stall < 3:
        m = int((want - len(ii) + 1024) / max(1.0 - miss_rate, 1e-6) * 1.2)
        ci = rng.integers(0, n, size=m)
        if pool is None:
            cj = rng.integers(0, l, size=m)
        else:
            cj = pool[rng.integers(0, len(pool), size=m)]
        ok = lookup(ci, cj) != MISSING
        cand = np.concatenate([ii, cj[ok] * np.int64(n) + ci[ok]])
        new = np.unique(cand)                            # sorted, distinct
        stall = stall + 1 if len(new) == len(ii) else 0
        ii = new
    if len(ii) < want:
        log.warning(
            "eval carve: only %d distinct non-missing entries found "
            "(requested %d); truncating eval sets proportionally",
            len(ii), want)
        n_val = int(round(len(ii) * n_val / want))
        n_held = len(ii) - n_val
        want = len(ii)
    ii = rng.permutation(ii)[:want]
    return (ii % n).astype(np.int32), (ii // n).astype(np.int32), n_val, \
        n_held


def _carve_entries(packed: np.ndarray, n: int, l: int, n_val: int,
                   n_held: int, rng: np.random.Generator,
                   snp_pool: int = 0):
    """Sample distinct non-missing entries, split validation/heldout and
    recode them MISSING in `packed` (in place). Returns (validation,
    heldout).

    Rejection sampling against the packed matrix (_sample_entries).
    snp_pool > 0 restricts the entries to a random pool of that many SNPs,
    which bounds the 'local' lambda mode's per-check eval re-solve.
    """
    if not n_val + n_held:
        return None, None
    pool = None
    if snp_pool and snp_pool < l:
        pool = rng.choice(l, size=snp_pool, replace=False).astype(np.int64)
    miss_rate = _missing_rate(packed, n, l, rng)
    obs_i, obs_j, n_val, n_held = _sample_entries(
        lambda i, j: _lookup_packed(packed, i, j), n, l, n_val, n_held, rng,
        pool, miss_rate)

    def make(sel):
        i, j = obs_i[sel], obs_j[sel]
        es = EntrySet(ind_idx=i, snp_idx=j, x=_lookup_packed(packed, i, j))
        _recode_missing_packed(packed, i, j)             # exclude from training
        return es

    validation = make(slice(0, n_val)) if n_val else None
    heldout = make(slice(n_val, n_val + n_held)) if n_held else None
    return validation, heldout


def carve_eval_device(packed, n: int, *, validation_frac: float = 0.005,
                      heldout_frac: float = 0.005, seed: int = 0,
                      max_eval_entries: Optional[int] = None,
                      eval_snp_pool: int = 2048):
    """The eval-set carve of a packed matrix that lives on a device (a
    uint8 tensor (L, ceil(n/4)), e.g. simulate_packed_device_resident's),
    without a host copy of it: the lookups (the missing-rate probe, the
    candidates, the entries' values) run on the device and only their
    index and value arrays cross to the host; the MISSING recode is one
    in-place scatter-OR of the touched bytes (entries sharing a byte
    merged on the host first). The entries are always drawn from a pool
    of eval_snp_pool SNPs. The pool, the probe and the candidates come
    from the reference's numpy generator (seed + 1,000,003) in its order,
    so a seed gives the reference's pool and entries on the same matrix.

    Returns (packed, validation, heldout, pool, eval_rows): packed
    recoded in place, the pool sorted (S,) int32, eval_rows the pool's
    recoded (S, W) rows on the device. Give pool and eval_rows to
    GenotypeData as eval_row_snps and eval_rows_full, so the local lambda
    mode's eval reads its rows on the device."""
    l, w = packed.shape
    if w != packed_width(n):
        raise ValueError(f"packed width {w} != ceil({n}/4)")
    dev = packed.device

    def idx(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.long)

    def lookup(i, j):
        it = idx(i)
        byte = packed[idx(j), it >> 2].to(torch.int32)
        return ((byte >> (2 * (it & 3))) & 3).to(torch.int8).cpu().numpy()

    rng = np.random.default_rng(seed + 1_000_003)
    pool = np.sort(rng.choice(l, size=min(eval_snp_pool, l),
                              replace=False).astype(np.int64))
    probe = 1 << 20              # the sampled missing rate, as at scale
    miss_rate = float((lookup(rng.integers(0, n, size=probe),
                              rng.integers(0, l, size=probe)) == MISSING
                       ).mean())
    nnz = int(n * l * (1.0 - miss_rate))
    cap = (GenotypeData.MAX_EVAL_ENTRIES if max_eval_entries is None
           else max_eval_entries)
    n_val = min(int(round(validation_frac * nnz)), cap)
    n_held = min(int(round(heldout_frac * nnz)), cap)
    if not n_val + n_held:
        return packed, None, None, pool.astype(np.int32), None
    obs_i, obs_j, n_val, n_held = _sample_entries(lookup, n, l, n_val,
                                                  n_held, rng, pool,
                                                  miss_rate)
    vals = lookup(obs_i, obs_j)

    # one OR mask per touched byte, then one scatter into the matrix
    m8 = (np.uint8(3) << (2 * (obs_i & 3)).astype(np.uint8))
    bkey = obs_j.astype(np.int64) * w + (obs_i >> 2)
    order = np.argsort(bkey, kind="stable")
    bkey_s, m8_s = bkey[order], m8[order]
    starts = np.flatnonzero(np.r_[True, bkey_s[1:] != bkey_s[:-1]])
    mm = torch.from_numpy(np.bitwise_or.reduceat(m8_s, starts)).to(dev)
    ub = bkey_s[starts]
    at = (idx(ub // w), idx(ub % w))
    packed.index_put_(at, packed[at] | mm)

    def make(sel):
        return EntrySet(ind_idx=obs_i[sel], snp_idx=obs_j[sel], x=vals[sel])

    validation = make(slice(0, n_val)) if n_val else None
    heldout = make(slice(n_val, n_val + n_held)) if n_held else None
    return (packed, validation, heldout, pool.astype(np.int32),
            packed[idx(pool)])


@dataclasses.dataclass
class GenotypeData:
    """Packed training matrix + eval sets. n individuals, l SNPs."""

    n: int
    l: int
    packed: np.ndarray                    # uint8 (l, W) train codes (or a
                                          # device tensor: carve_eval_device)
    validation: Optional[EntrySet] = None
    heldout: Optional[EntrySet] = None
    ind_ids: Optional[list] = None        # individual labels (.fam)
    snp_ids: Optional[list] = None        # SNP labels (.bim)
    # Origin of `packed` in the whole matrix: a rank's block
    # (parallel/multihost.load_bed_shard) starts at these.
    byte_col_offset: int = 0
    snp_row_offset: int = 0
    # Full-width packed rows of the eval-SNP pool and their sorted SNP
    # indices (the multi-rank loader sets them), so the local lambda
    # mode's eval re-solve works where `packed` is a block.
    eval_rows_full: Optional[np.ndarray] = None   # (S, ceil(n/4)) uint8
    # (a device tensor where carve_eval_device carved `packed` there)
    eval_row_snps: Optional[np.ndarray] = None    # (S,) int32 sorted

    # Per-set eval cap: ~500K entries already give MC error ~1e-3 nats.
    MAX_EVAL_ENTRIES = 500_000

    @property
    def is_local_slice(self) -> bool:
        """Whether `packed` is a block of the matrix, not all of it."""
        return (self.byte_col_offset != 0 or self.snp_row_offset != 0
                or self.packed.shape != (self.l, packed_width(self.n)))

    def pad_snps(self, multiple: int) -> "GenotypeData":
        """Pad L up to a multiple with all-MISSING rows (0xFF) for an even
        split. Padding SNPs contribute nothing where they are drawn."""
        lp = -(-self.l // multiple) * multiple
        if lp == self.packed.shape[0]:
            return self
        pad = np.full((lp - self.packed.shape[0], self.packed.shape[1]),
                      0xFF, dtype=np.uint8)
        return dataclasses.replace(
            self, packed=np.concatenate([self.packed, pad]))

    @classmethod
    def from_packed(
        cls,
        packed: np.ndarray,               # uint8 (l, ceil(n/4))
        n: int,
        *,
        validation_frac: float = 0.005,
        heldout_frac: float = 0.005,
        seed: int = 0,
        ind_ids=None,
        snp_ids=None,
        max_eval_entries: Optional[int] = None,
        eval_snp_pool: int = 0,
        copy: bool = False,
    ) -> "GenotypeData":
        """Carve eval sets directly on a packed matrix (mutated in place
        unless copy=True; an np.memmap stays one, so a fit can stream
        it)."""
        l = packed.shape[0]
        if packed.shape[1] != packed_width(n):
            raise ValueError(f"packed width {packed.shape[1]} != ceil({n}/4)")
        if copy:
            packed = packed.copy()
        rng = np.random.default_rng(seed + 1_000_003)
        cap = (cls.MAX_EVAL_ENTRIES if max_eval_entries is None
               else max_eval_entries)
        miss_rate = _missing_rate(packed, n, l, rng)
        nnz = int(n * l * (1.0 - miss_rate))
        n_val = min(int(round(validation_frac * nnz)), cap)
        n_held = min(int(round(heldout_frac * nnz)), cap)
        validation, heldout = _carve_entries(
            packed, n, l, n_val, n_held, rng, snp_pool=eval_snp_pool)
        return cls(n=n, l=l, packed=packed, validation=validation,
                   heldout=heldout, ind_ids=ind_ids, snp_ids=snp_ids)

    @classmethod
    def from_bed(
        cls,
        path: str,
        *,
        validation_frac: float = 0.005,
        heldout_frac: float = 0.005,
        seed: int = 0,
        max_eval_entries: Optional[int] = None,
        eval_snp_pool: int = 0,
    ) -> "GenotypeData":
        """PLINK .bed (+ sibling .fam/.bim) -> packed dataset: one pass
        into the packed layout (peak host memory n*l/4 bytes, never the
        dense n*l), then the carve. For a matrix larger than host memory,
        ingest with data/bed.bed_to_packed_cache and carve the memmap with
        `from_packed`."""
        from terastructure_tpu_torch.data.bed import read_bed

        packed, ind_ids, snp_ids = read_bed(path)
        return cls.from_packed(
            packed, len(ind_ids),
            validation_frac=validation_frac, heldout_frac=heldout_frac,
            seed=seed, ind_ids=ind_ids, snp_ids=snp_ids,
            max_eval_entries=max_eval_entries, eval_snp_pool=eval_snp_pool)

    @classmethod
    def from_dense(
        cls,
        x: np.ndarray,                    # (n, l) int in {0,1,2,MISSING}
        *,
        validation_frac: float = 0.005,
        heldout_frac: float = 0.005,
        seed: int = 0,
        ind_ids=None,
        snp_ids=None,
        max_eval_entries: Optional[int] = None,
        eval_snp_pool: int = 0,
    ) -> "GenotypeData":
        n, _ = x.shape
        xt = np.ascontiguousarray(x.T).astype(np.int8)   # (l, n) SNP-major
        return cls.from_packed(
            pack2bit(xt), n,
            validation_frac=validation_frac, heldout_frac=heldout_frac,
            seed=seed, ind_ids=ind_ids, snp_ids=snp_ids,
            max_eval_entries=max_eval_entries, eval_snp_pool=eval_snp_pool)
